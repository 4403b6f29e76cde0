// K1 conv_gemm_f32 and conv_implicit_f32, K2 bmm_f32: one fp32 GEMM, three
// entries, two bodies.
//
// Replaces
//   K1  src/repro/kernels/spatial_conv/kernel.py :: conv_gemm_kernel
//       (the Spatial-mode PE: (T, C*R*S) @ (C*R*S, K) + bias, optional ReLU;
//       conv_gemm_f32 over a patch matrix, conv_implicit_f32 over the NHWC
//       map itself, where the tensor-core body finds each chunk of a patch
//       in the map and the pads read as zeros, so no patch matrix and no
//       padded copy of the map is written)
//   K2  src/repro/kernels/gemm/kernel.py :: batched_matmul_kernel
//       ((G, M, K) @ (G, K, N), optional (G, N) bias + ReLU epilogue; the
//       PT^2-batched Winograd GEMM and, with G = 1, the FC layer)
//
// What bounds it on an H100: the conv GEMMs of the main path do 2*M*N*K
// operations on O(M*K + K*N + M*N) words, far above the ridge point, so
// operations bound them. On the fp32 FMA pipes (67 TFLOP/s) VGG16's nine
// Spatial CONVs take at least 2.1 ms a request. The tensor cores take fp32
// only as TF32 (10 bits of mantissa), and one TF32 product misses the
// 1e-4 * max(1, max|ref|) the fp32 path is held to at K = 4608. The FC
// layers at batch 8 are the opposite: each weight is used 8 times, so the
// bytes of the weight matrix bound them, on any pipe.
//
// Route "tc3xtf32" (M >= 64, K and N multiples of 4, 16-byte aligned
// operands: every main-path CONV GEMM but the K = 27 of VGG16's conv0 and
// ResNet-18's stem): 3xTF32 on wgmma. Each operand is split on the card
// into x = hi + lo, hi = tf32(x), lo = tf32(x - hi), rounded to nearest as
// cvt.rna does (by integer operations, which are faster here; the
// subtraction is exact), which rebuilds x to about 2**-22 of it. Three
// products, lo*hi + hi*lo + hi*hi, small ones first, go into one fp32
// accumulator; lo*lo, about 2**-22 of the product, is left out. So the
// tensor cores do 3x the useful work, and 3 * operations / 494.7 TFLOP/s
// (dense TF32) is this route's floor: 0.90 ms for VGG16's K1.
//
// wgmma reads tf32 operands from shared memory K-major only, and B (the
// weights (CRS, K), U (C, K)) is N-major, so B is transposed on its way to
// the tensor cores; with the split, preparing a slab is as much work as
// multiplying it. When the same threads copy, split and multiply, the two
// run one after the other, since queueing wgmmas holds a warp until the
// tensor cores take them. So the work is divided between warps:
// persistent blocks of 512 threads, one per SM, walk output tiles of
// 128 x BN (BN 128, or 64 where N <= 64) and their K in 32-float slabs
// (one 128-byte swizzled row), one stream of slabs across the tiles.
// - Two producer warpgroups copy each slab as fp32 (A 128 x 32, B 32 x BN)
//   with cp.async into a ring of four raw stages, two slabs ahead, and
//   split B into TF32 hi and lo planes, K-major, in a ring of three split
//   stages: 4 x 4 blocks read as four 16-byte rows, transposed in
//   registers, stored with the 128-byte swizzle, free of bank conflicts.
// - Two consumer warpgroups (64 rows each) read their A fragments from the
//   raw stage, split them in registers, and issue 12 wgmmas a slab
//   (m64nBNk8, A from registers, B from shared memory, 4 k-steps x 3
//   products), then wait for them; at the end of a tile they store it
//   while the producers already fill the next tile's slabs.
// - Named barriers hand the slabs over: the producers mark a slab ready
//   (its B split, its raw A landed), the consumers mark it done (its
//   products finished, the next slab's fragments loaded), and a stage is
//   refilled only after the mark that frees it. 193 KB of shared memory
//   (BN 128); `python -m repro_torch.kernels.gemm.breakdown` prices each
//   choice.
//
// Routes "fma" and "fma_splitk" (K = 27, the M = 8 FC layers, misaligned
// operands, any other shape): a register-tiled SGEMM on the FMA pipes. Each
// block owns a BM x BN tile and walks K in BK-deep slabs, double-buffered
// in shared memory, the next slab's global loads held in registers while
// the block computes; A is stored k-major; each thread keeps a TM x TN
// register tile. Where K, N and the pointers allow, loads and stores are
// 16-byte vectors; other shapes take a scalar path. Three tiles: 128x128
// for wide GEMMs with enough tiles to fill the card, 128x64 for narrow or
// few-tile ones, 16x64 for the skinny-M FC GEMMs.
//
// Both bodies: when the output tiles cannot fill the card (VGG16's
// conv10-12, ResNet-18's stages 2-4, the FC layers), K is split across
// blocks that write fp32 partial tiles to a caller-provided workspace, and
// a second pass sums the partials in split order (deterministic) and
// applies bias and ReLU; this also keeps enough weight bytes in flight for
// the byte-bound FC layers. Otherwise bias and ReLU are fused at the store
// (NaN passes, as torch.relu). Ragged edges in M, N and K are masked in the
// kernel, so the wrapper pads nothing. Offsets are 64-bit; G is the FMA
// grid's y and part of the tensor-core work items. The IS/WS dataflow picks
// the raster order of output tiles (IS: consecutive blocks share an A
// row-panel; WS: a B column-panel) and changes no numbers. The route
// depends on shape and alignment alone (gemm_f32_route names it); nothing
// falls back from one to the other.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kAPad = 4;   // keeps As rows 16-byte aligned and stores spread

template <int BM, int BN, int BK, int TM, int TN>
struct Shape {
  static constexpr int TX = BN / TN;    // threads along n
  static constexpr int TY = BM / TM;    // threads along m
  static constexpr int NT = TX * TY;
  static constexpr int RS = TY * 4;     // stride between a thread's row groups
  static constexpr int CS = TX * 4;     // stride between its column groups
  static_assert(TM % 4 == 0 && TN % 4 == 0, "register tile in 4-wide groups");
  static_assert(BM % TM == 0 && BN % TN == 0, "register tile must divide");
  static_assert(BK % 4 == 0, "slab depth in 4-wide steps");
};

// Moves one BK-deep slab of A (BM x BK of a row-major M x K) and B (BK x BN
// of a row-major K x N) from global memory into registers (load) and from
// there into shared memory (store). Elements outside [M) x [k_end) and
// [k_end) x [N) read as zero.
template <int BM, int BN, int BK, int TM, int TN, bool VEC>
struct Slab;

template <int BM, int BN, int BK, int TM, int TN>
struct Slab<BM, BN, BK, TM, TN, true> {       // 16-byte vectors
  using S = Shape<BM, BN, BK, TM, TN>;
  static constexpr int kA = BM * BK / 4, kB = BK * BN / 4;
  static constexpr int LA = (kA + S::NT - 1) / S::NT;
  static constexpr int LB = (kB + S::NT - 1) / S::NT;
  float4 ra[LA], rb[LB];

  __device__ __forceinline__ void load(const float* A, const float* B,
                                       int64_t M, int64_t K, int64_t N,
                                       int64_t m0, int64_t n0, int64_t k0,
                                       int64_t k_end, int tid) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int e = tid + l * S::NT;
      const int64_t gm = m0 + e / (BK / 4), gk = k0 + (e % (BK / 4)) * 4;
      ra[l] = (e < kA && gm < M && gk < k_end)
                  ? *reinterpret_cast<const float4*>(A + gm * K + gk)
                  : zero;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int e = tid + l * S::NT;
      const int64_t gk = k0 + e / (BN / 4), gn = n0 + (e % (BN / 4)) * 4;
      rb[l] = (e < kB && gk < k_end && gn < N)
                  ? *reinterpret_cast<const float4*>(B + gk * N + gn)
                  : zero;
    }
  }

  __device__ __forceinline__ void store(float (*As)[BM + kAPad],
                                        float (*Bs)[BN], int tid) const {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int e = tid + l * S::NT;
      if (e < kA) {
        const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
        As[c][r] = ra[l].x;
        As[c + 1][r] = ra[l].y;
        As[c + 2][r] = ra[l].z;
        As[c + 3][r] = ra[l].w;
      }
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int e = tid + l * S::NT;
      if (e < kB) {
        const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
        *reinterpret_cast<float4*>(&Bs[r][c]) = rb[l];
      }
    }
  }
};

template <int BM, int BN, int BK, int TM, int TN>
struct Slab<BM, BN, BK, TM, TN, false> {      // scalar, any shape
  using S = Shape<BM, BN, BK, TM, TN>;
  static constexpr int kA = BM * BK, kB = BK * BN;
  static constexpr int LA = (kA + S::NT - 1) / S::NT;
  static constexpr int LB = (kB + S::NT - 1) / S::NT;
  float ra[LA], rb[LB];

  __device__ __forceinline__ void load(const float* A, const float* B,
                                       int64_t M, int64_t K, int64_t N,
                                       int64_t m0, int64_t n0, int64_t k0,
                                       int64_t k_end, int tid) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int e = tid + l * S::NT;
      const int64_t gm = m0 + e / BK, gk = k0 + e % BK;
      ra[l] = (e < kA && gm < M && gk < k_end) ? A[gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int e = tid + l * S::NT;
      const int64_t gk = k0 + e / BN, gn = n0 + e % BN;
      rb[l] = (e < kB && gk < k_end && gn < N) ? B[gk * N + gn] : 0.f;
    }
  }

  __device__ __forceinline__ void store(float (*As)[BM + kAPad],
                                        float (*Bs)[BN], int tid) const {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int e = tid + l * S::NT;
      if (e < kA) As[e % BK][e / BK] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int e = tid + l * S::NT;
      if (e < kB) Bs[e / BN][e % BN] = rb[l];
    }
  }
};

// gridDim = (tiles_m * tiles_n, G, splits). With splits > 1, block z
// computes the partial product over K in [z * k_chunk, (z + 1) * k_chunk)
// into C = the (splits, G, M, N) workspace, without bias or ReLU.
template <int BM, int BN, int BK, int TM, int TN, bool VEC>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ bias, float* __restrict__ C,
                int64_t M, int64_t K, int64_t N, int64_t bias_stride,
                int64_t tiles_m, int64_t tiles_n, int64_t k_chunk, int relu,
                int ws) {
  using S = Shape<BM, BN, BK, TM, TN>;
  __shared__ __align__(16) float As[2][BK][BM + kAPad];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int64_t g = blockIdx.y, split = blockIdx.z;
  const int64_t tile = blockIdx.x;
  int64_t tm, tn;
  if (ws) {
    tm = tile % tiles_m;
    tn = tile / tiles_m;
  } else {
    tn = tile % tiles_n;
    tm = tile / tiles_n;
  }
  const int64_t m0 = tm * BM, n0 = tn * BN;
  A += g * M * K;
  B += g * K * N;
  C += (split * gridDim.y + g) * M * N;
  const int64_t k_begin = split * k_chunk;
  const int64_t k_end = k_begin + k_chunk < K ? k_begin + k_chunk : K;
  const int n_slabs = k_end > k_begin
                          ? static_cast<int>((k_end - k_begin + BK - 1) / BK)
                          : 0;
  const int tid = threadIdx.x;
  const int tx = tid % S::TX, ty = tid / S::TX;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  Slab<BM, BN, BK, TM, TN, VEC> slab;
  if (n_slabs > 0) {
    slab.load(A, B, M, K, N, m0, n0, k_begin, k_end, tid);
    slab.store(As[0], Bs[0], tid);
  }
  __syncthreads();

  for (int s = 0; s < n_slabs; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < n_slabs;
    if (more)   // the next slab's global loads fly while this one computes
      slab.load(A, B, M, K, N, m0, n0, k_begin + (s + 1) * BK, k_end, tid);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int gi = 0; gi < TM / 4; ++gi) {
        const float4 v = *reinterpret_cast<const float4*>(
            &As[buf][kk][gi * S::RS + ty * 4]);
        a[gi * 4] = v.x;
        a[gi * 4 + 1] = v.y;
        a[gi * 4 + 2] = v.z;
        a[gi * 4 + 3] = v.w;
      }
#pragma unroll
      for (int hj = 0; hj < TN / 4; ++hj) {
        const float4 v = *reinterpret_cast<const float4*>(
            &Bs[buf][kk][hj * S::CS + tx * 4]);
        b[hj * 4] = v.x;
        b[hj * 4 + 1] = v.y;
        b[hj * 4 + 2] = v.z;
        b[hj * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) slab.store(As[buf ^ 1], Bs[buf ^ 1], tid);
    __syncthreads();
  }

  const bool partial = gridDim.z > 1;
#pragma unroll
  for (int gi = 0; gi < TM / 4; ++gi) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = gi * 4 + r;
      const int64_t gm = m0 + gi * S::RS + ty * 4 + r;
      if (gm >= M) continue;
#pragma unroll
      for (int hj = 0; hj < TN / 4; ++hj) {
        const int64_t gn = n0 + hj * S::CS + tx * 4;
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          v[c] = acc[i][hj * 4 + c];
          if (!partial && gn + c < N) {
            if (bias != nullptr) v[c] += bias[g * bias_stride + gn + c];
            if (relu && v[c] < 0.f) v[c] = 0.f;   // NaN passes, as torch.relu
          }
        }
        if (VEC) {
          if (gn < N)
            *reinterpret_cast<float4*>(C + gm * N + gn) =
                make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (gn + c < N) C[gm * N + gn + c] = v[c];
        }
      }
    }
  }
}

// Second pass of a split-K GEMM: C = sum over splits (in order) of the
// partials, + bias, ReLU. One thread per output element.
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ part,
                     const float* __restrict__ bias, float* __restrict__ C,
                     int64_t splits, int64_t plane, int64_t MN, int64_t N,
                     int64_t bias_stride, int relu) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= plane) return;
  float v = 0.f;
  for (int64_t s = 0; s < splits; ++s) v += part[s * plane + idx];
  if (bias != nullptr) v += bias[(idx / MN) * bias_stride + idx % N];
  if (relu && v < 0.f) v = 0.f;
  C[idx] = v;
}

// ---------------------------------------------------------------------------
// Route tc3xtf32: three TF32 products on wgmma
// ---------------------------------------------------------------------------

constexpr int kTcBM = 128;       // output rows a block owns: two warpgroups
constexpr int kTcBK = 32;        // floats of K a slab: one swizzled row
constexpr int kTcKSteps = kTcBK / 8;   // k8 steps of wgmma a slab
constexpr int kConsumers = 256;  // two warpgroups: the products
constexpr int kProducers = 256;  // two warpgroups: copies and B's split
constexpr int kTcThreads = kConsumers + kProducers;
// A's 16-byte chunks a producer thread copies of each slab, and the rows
// between them
constexpr int kTcLA = kTcBM * kTcBK / 4 / kProducers;
constexpr int kARows = kProducers / 8;
constexpr int kRawStages = 4;    // fp32 slabs in the cp.async ring
constexpr int kSplitStages = 3;  // B's hi and lo planes, ready for wgmma
// slabs whose copies are in flight ahead of the one being split
constexpr int kCopyAhead = kRawStages - kSplitStages + 1;
// named barriers: slab ready and slab done (one per split stage each), the
// producers among themselves
constexpr int kBarReady = 1, kBarDone = kBarReady + kSplitStages;
constexpr int kBarProducers = kBarDone + kSplitStages;

template <int BN>
struct TcTile {
  static constexpr int kAPlane = kTcBM * kTcBK * 4;    // bytes
  static constexpr int kBPlane = BN * kTcBK * 4;
  // a raw stage: A (128 x 32) and B (32 x BN) as copied, fp32
  static constexpr int kRaw = kAPlane + kBPlane;
  // a split stage: B hi and B lo, K-major (BN rows each)
  static constexpr int kSplit = 2 * kBPlane;
  static constexpr int kRawBase = kSplitStages * kSplit;
  static constexpr int kSmem = kRawBase + kRawStages * kRaw + 1024;  // align
  static constexpr int kAChunks = kTcBM * kTcBK / 4;   // 16-byte chunks
  static constexpr int kBChunks = kTcBK * BN / 4;
  static constexpr int LB = kBChunks / kProducers;
  static constexpr int kBBlocks = (BN / 4) * (kTcBK / 4);   // 4 x 4 blocks
  static constexpr int LBB = (kBBlocks + kProducers - 1) / kProducers;
  static constexpr int kAcc = BN / 2;     // accumulator floats a thread
  static_assert(kAChunks % kProducers == 0 && kBChunks % kProducers == 0,
                "copies per producer thread");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// D (64 x 64, fp32) += A (64 x 8) B (8 x 64): A tf32 in registers (the
// fragment of mma.m16n8k8 per warp), B tf32 in shared memory, K-major
// (128-byte swizzle).
__device__ __forceinline__ void wgmma_tf32_m64n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 8) B (8 x 128): A tf32 in registers (the
// fragment of mma.m16n8k8 per warp), B tf32 in shared memory, K-major
// (128-byte swizzle).
__device__ __forceinline__ void wgmma_tf32_m64n128(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db);
template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  wgmma_tf32_m64n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  wgmma_tf32_m64n128(d, a, db);
}

// x rounded to TF32 (10 bits of mantissa; to nearest, ties away from
// zero), as fp32 bits: what cvt.rna.tf32.f32 computes, in two integer
// operations on the full-rate pipes. Adding half of the 13 dropped bits
// rounds the magnitude; a carry into the exponent is the right rounding. An
// infinity stays one; a NaN may become one, and then lo = x - hi is NaN.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// Stores the four values as TF32 hi (at shared address hi) and lo (at lo):
// x = hi + lo to about 2**-22 of x; the subtraction is exact.
__device__ __forceinline__ void st_split(uint32_t hi, uint32_t lo, float x0,
                                         float x1, float x2, float x3) {
  const uint32_t h0 = tf32_bits(x0), h1 = tf32_bits(x1), h2 = tf32_bits(x2),
                 h3 = tf32_bits(x3);
  st_shared_v4(hi, h0, h1, h2, h3);
  st_shared_v4(lo, tf32_bits(x0 - __uint_as_float(h0)),
               tf32_bits(x1 - __uint_as_float(h1)),
               tf32_bits(x2 - __uint_as_float(h2)),
               tf32_bits(x3 - __uint_as_float(h3)));
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld_shared_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Byte offset of B's 16-byte chunk n4 (columns 4 n4 .. 4 n4 + 3) of row k
// in a raw stage: rows of BN floats, the chunk at n4 ^ ((k / 4) % 8), so
// that the eight rows 4 q + j (q < 8) that eight threads read at once
// fall on eight different bank groups.
template <int BN>
__device__ __forceinline__ uint32_t raw_b(int k, int n4) {
  return static_cast<uint32_t>(k * BN * 4 + ((n4 ^ ((k >> 2) & 7)) << 4));
}

// Where the tensor-core body finds A. Each source has Rows: a producer
// thread's kTcLA chunks of one work item, rows m + l * kARows, all at the
// column k (a multiple of 4) of the item's first slab; copy() moves them
// for one slab, zero-filling those outside [M) x [k_end), and moves on to
// the next slab's column, k + kTcBK.
//
// DenseA: a row-major (G, M, K) array (K2, and K1 over im2col patches).
struct DenseA {
  const float* a;

  struct Rows {
    const float* at;    // row m of product g, at the slab's column
    int64_t k, step;    // the slab's column; floats from chunk l to l + 1
    uint32_t ok;        // bit l: chunk l's row is inside M

    __device__ __forceinline__ Rows(const DenseA& src, int64_t g, int64_t M,
                                    int64_t K, int64_t m, int64_t k0)
        : at(src.a + (g * M + m) * K + k0), k(k0), step(kARows * K) {
      ok = 0;
#pragma unroll
      for (int l = 0; l < kTcLA; ++l)
        if (m + l * kARows < M) ok |= 1u << l;
    }

    // the chunks into dst + l * kARows * 128 (one swizzled row of 128
    // bytes a row)
    __device__ __forceinline__ void copy(uint32_t dst, const DenseA& src,
                                         int64_t k_end) {
      const bool k_ok = k < k_end;
#pragma unroll
      for (int l = 0; l < kTcLA; ++l) {
        const bool in = k_ok && ((ok >> l) & 1u);
        cp_async16(dst + l * kARows * 128,
                   in ? static_cast<const void*>(at + l * step) : src.a,
                   in ? 16 : 0);
      }
      k += kTcBK;
      at += kTcBK;
    }
  };
};

// ConvA: the patch matrix of an NHWC map x, never built (K1's implicit
// GEMM). Row m = (n HO + oh) WO + ow is output pixel (n, oh, ow); column
// k = (r S + s) C + ch is channel ch of tap (r, s), which reads
// x[n, oh stride - pad_top + r, ow stride - pad_left + s, ch], and 0 where
// that lies outside the map: the pads are geometry, never copies. C % 4 ==
// 0, so a chunk never straddles two taps, and with C a multiple of 32 a
// slab's row is one contiguous 128-byte run of the map. Rows finds its
// rows' pixels once an item (M < 2**31) and walks (r, s, ch) from slab to
// slab without dividing.
struct ConvA {
  const float* x;
  int64_t sn, sh, sw;   // strides in floats (multiples of 4); C contiguous
  int h, w, c, s, stride, pad_top, pad_left, ho, wo;

  struct Rows {
    int64_t base[kTcLA];         // offset of x[n, ih0, iw0, 0], maybe outside
    int ih0[kTcLA], iw0[kTcLA];  // the patch's corner in the map
    int64_t k, off;              // the slab's column; r sh + s sw + ch
    int r, s, ch;                // its tap and channel

    __device__ __forceinline__ Rows(const ConvA& src, int64_t, int64_t M,
                                    int64_t, int64_t m, int64_t k0)
        : k(k0) {
      const int hw = src.ho * src.wo;
#pragma unroll
      for (int l = 0; l < kTcLA; ++l) {
        const int ml = static_cast<int>(m) + l * kARows;
        const int n = ml / hw, q = ml - n * hw;
        const int oh = q / src.wo, ow = q - oh * src.wo;
        // a row past M starts below the map: each of its taps reads 0
        ih0[l] = ml < M ? oh * src.stride - src.pad_top : src.h;
        iw0[l] = ow * src.stride - src.pad_left;
        base[l] = n * src.sn + static_cast<int64_t>(ih0[l]) * src.sh +
                  static_cast<int64_t>(iw0[l]) * src.sw;
      }
      const int kk = static_cast<int>(k0), tap = kk / src.c;
      ch = kk - tap * src.c;
      r = tap / src.s;
      s = tap - r * src.s;
      off = r * src.sh + s * src.sw + ch;
    }

    __device__ __forceinline__ void copy(uint32_t dst, const ConvA& src,
                                         int64_t k_end) {
      const bool k_ok = k < k_end;
#pragma unroll
      for (int l = 0; l < kTcLA; ++l) {
        const bool in =
            k_ok &&
            static_cast<unsigned>(ih0[l] + r) < static_cast<unsigned>(src.h) &&
            static_cast<unsigned>(iw0[l] + s) < static_cast<unsigned>(src.w);
        cp_async16(dst + l * kARows * 128,
                   in ? static_cast<const void*>(src.x + base[l] + off)
                      : src.x,
                   in ? 16 : 0);
      }
      k += kTcBK;
      ch += kTcBK;
      off += kTcBK;
      while (ch >= src.c) {   // once at most where C % 32 == 0
        ch -= src.c;
        off += src.sw - src.c;
        if (++s == src.s) {
          s = 0;
          ++r;
          off += src.sh - src.s * src.sw;
        }
      }
    }
  };
};

// One 32-deep slab of A (128 x 32 of an M x K operand, from a DenseA or a
// ConvA) and B (32 x BN of a row-major K x N). A Copier (producer thread p)
// moves it as fp32 into a raw stage with cp.async, 16-byte chunks, those
// outside [M) x [k_end) and [k_end) x [N) zero-filled (K and N are
// multiples of 4); A chunk e is row e / 8, chunk e % 8, swizzled. split_b()
// (producer thread p) splits B into
// TF32 hi and lo planes, K-major: 4 x 4 block e covers k = 4 (e % 8) + j,
// j < 4, and columns 4 (e / 8) + i, i < 4; its four row chunks are read and
// transposed in registers into one 16-byte chunk of each column's rows.
// frags() (a consumer thread) reads its A fragments from the raw stage and
// splits them into TF32 hi and lo in registers. Eight threads in a row of a
// warp touch eight different bank groups everywhere: no conflicts.
template <int BN>
struct TcSlab {
  using T = TcTile<BN>;

  // What a producer thread p copies of every slab: A chunks e = p + l *
  // kProducers are rows p / 8 + l * kARows, all at chunk p % 8 (Src's
  // Rows); B chunks are rows e / (BN / 4), all at column chunk p % (BN / 4).
  template <class Src>
  struct Copier {
    typename Src::Rows a;
    const float* b;    // B's row of chunk 0 of slab 0, at its column
    int64_t b_row_step;  // floats from chunk l to l + 1
    int b_row0;
    uint32_t a_dst0;
    bool b_col_ok;

    // the item's slabs start at column k_begin
    __device__ __forceinline__ Copier(const Src& src, const float* B,
                                      int64_t g, int64_t M, int64_t K,
                                      int64_t N, int64_t m0, int64_t n0,
                                      int64_t k_begin, int p)
        : a(src, g, M, K, m0 + p / 8, k_begin + (p % 8) * 4) {
      constexpr int kBRows = kProducers / (BN / 4);
      a_dst0 = swizzled(kTcBM, p / 8, p % 8);   // + l * kARows * 128
      b_row0 = p / (BN / 4);
      const int64_t gn = n0 + (p % (BN / 4)) * 4;
      b = B + b_row0 * N + gn;
      b_row_step = kBRows * N;
      b_col_ok = gn < N;
    }

    // slab at k0, the item's next (k_end the end of the block's K chunk),
    // into a raw stage
    __device__ __forceinline__ void operator()(uint32_t raw, const Src& src,
                                               const float* B, int64_t N,
                                               int64_t k0, int64_t k_end,
                                               int p) {
      constexpr int kBRows = kProducers / (BN / 4);
      a.copy(raw + a_dst0, src, k_end);
      const float* bs = b + k0 * N;
#pragma unroll
      for (int l = 0; l < T::LB; ++l) {
        const int k = b_row0 + l * kBRows;
        const bool ok = b_col_ok && k0 + k < k_end;
        cp_async16(raw + T::kAPlane + raw_b<BN>(k, p % (BN / 4)),
                   ok ? static_cast<const void*>(bs + l * b_row_step) : B,
                   ok ? 16 : 0);
      }
    }
  };

  static __device__ __forceinline__ void split_b(uint32_t raw,
                                                 uint32_t split, int p) {
    const uint32_t b_raw = raw + T::kAPlane;
#pragma unroll
    for (int l = 0; l < T::LBB; ++l) {
      const int e = p + l * kProducers;
      if (e >= T::kBBlocks) continue;
      const int kc = e % 8, ng = e / 8;
      float4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = ld_shared_v4(b_raw + raw_b<BN>(4 * kc + j, ng));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t off = swizzled(BN, 4 * ng + i, kc);
        st_split(split + off, split + T::kBPlane + off, lane_of(v[0], i),
                 lane_of(v[1], i), lane_of(v[2], i), lane_of(v[3], i));
      }
    }
  }

  // The A operand of each k-step kk for rows row0 + (0, 8) of the warp's
  // 16: register r holds (row0 + 8 (r % 2), 8 kk + col + 4 (r / 2)), col the
  // thread's column (lane % 4), as mma.m16n8k8 lays out tf32 A.
  static __device__ __forceinline__ void frags(
      uint32_t raw, int row0, int col, uint32_t (&hi)[kTcKSteps][4],
      uint32_t (&lo)[kTcKSteps][4]) {
#pragma unroll
    for (int kk = 0; kk < kTcKSteps; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row0 + 8 * (r % 2);
        const float x = ld_shared_f32(
            raw + swizzled(kTcBM, row, 2 * kk + r / 2) + 4 * col);
        hi[kk][r] = tf32_bits(x);
        lo[kk][r] = tf32_bits(x - __uint_as_float(hi[kk][r]));
      }
  }
};

// One output tile of one split of one of the G products: a work item.
// Items run tile first, then g, then split.
struct TcWork {
  const float* b;     // B of this g
  float* c;           // C of this g and split (the workspace when split)
  int64_t g, m0, n0, k_begin, k_end;
  int n_slabs;
};

// A persistent block of 512 threads walks the work items blockIdx.x,
// blockIdx.x + gridDim.x, ...; its slabs, item after item, are one stream
// that the producers and consumers number the same way (v), so the rings
// run on across items and one item's epilogue overlaps the next one's
// copies. With splits > 1 item (split, g, tile) writes the partial product
// over its K chunk into the (splits, G, M, N) workspace. Every item has at
// least one slab (the plan keeps every split's chunk inside [0, K)). A
// comes from `src` (DenseA or ConvA); nothing else depends on it.
template <int BN, class Src>
__device__ __forceinline__ void tc_gemm(
    const Src& src, const float* __restrict__ B,
    const float* __restrict__ bias, float* __restrict__ C, int64_t G,
    int64_t M, int64_t K, int64_t N, int64_t bias_stride, int64_t tiles_m,
    int64_t tiles_n, int64_t splits, int64_t k_chunk, int relu, int ws) {
  using T = TcTile<BN>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;

  // the warpgroup index broadcast from lane 0, so that the compiler knows
  // it is uniform across the warp and keeps the wgmmas asynchronous
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid % 128) / 32, lane = tid % 32;

  const int64_t tiles = tiles_m * tiles_n, items = tiles * G * splits;
  auto work = [&](int64_t w) {
    TcWork it;
    const int64_t tile = w % tiles, gs = w / tiles;
    it.g = gs % G;
    const int64_t split = gs / G;
    int64_t tm, tn;
    if (ws) {
      tm = tile % tiles_m;
      tn = tile / tiles_m;
    } else {
      tn = tile % tiles_n;
      tm = tile / tiles_n;
    }
    it.m0 = tm * kTcBM;
    it.n0 = tn * BN;
    it.b = B + it.g * K * N;
    it.c = C + (split * G + it.g) * M * N;
    it.k_begin = split * k_chunk;
    it.k_end = it.k_begin + k_chunk < K ? it.k_begin + k_chunk : K;
    it.n_slabs = static_cast<int>((it.k_end - it.k_begin + kTcBK - 1) /
                                  kTcBK);
    return it;
  };
  int total = 0;   // slabs of this block
  for (int64_t w = blockIdx.x; w < items; w += gridDim.x)
    total += work(w).n_slabs;

  const uint32_t raw0 = base + T::kRawBase;
  auto raw = [&](int v) { return raw0 + (v % kRawStages) * T::kRaw; };
  // named barrier of slab v's mark (v >= -1)
  auto done_bar = [](int v) {
    return kBarDone + (v + kSplitStages) % kSplitStages;
  };

  // Producer warpgroups: slab j's copies go out kCopyAhead slabs ahead;
  // once they have landed they split B into split stage j % kSplitStages
  // and mark slab j ready. Consumers mark slab v done once their products
  // of it have finished and they hold the fragments of slab v + 1 (v = -1:
  // they hold slab 0's). Before the producers rewrite split stage
  // j % kSplitStages and refill the raw stage of slab j + kCopyAhead -
  // kRawStages they wait for the mark of slab j - kSplitStages.
  if (wg >= kConsumers / 128) {
    const int p = tid - kConsumers;
    // the next slab to copy: item w, its slab s
    int64_t w = blockIdx.x;
    int s = 0;
    TcWork it = work(w);
    using Copier = typename TcSlab<BN>::template Copier<Src>;
    Copier copier(src, it.b, it.g, M, K, N, it.m0, it.n0, it.k_begin, p);
    auto copy = [&](int v) {
      if (w < items) {
        copier(raw(v), src, it.b, N,
               it.k_begin + static_cast<int64_t>(s) * kTcBK, it.k_end, p);
        if (++s == it.n_slabs) {
          s = 0;
          w += gridDim.x;
          if (w < items) {
            it = work(w);
            copier = Copier(src, it.b, it.g, M, K, N, it.m0, it.n0,
                            it.k_begin, p);
          }
        }
      }
      cp_async_commit();
    };
    for (int v = 0; v < kCopyAhead; ++v) copy(v);
    for (int j = 0; j < total; ++j) {
      if (j >= kSplitStages - 1) bar_sync(done_bar(j - kSplitStages),
                                          kTcThreads);
      copy(j + kCopyAhead);
      cp_async_wait<kCopyAhead>();
      bar_sync(kBarProducers, kProducers);   // every producer's copies
      TcSlab<BN>::split_b(raw(j), base + (j % kSplitStages) * T::kSplit, p);
      fence_proxy_async();
      bar_arrive(kBarReady + j % kSplitStages, kTcThreads);
    }
    // the consumers' marks not waited for yet
    const int first = total - kSplitStages > -1 ? total - kSplitStages : -1;
    for (int v = first; v <= total - 2; ++v)
      bar_sync(done_bar(v), kTcThreads);
    return;
  }

  // Consumer warpgroups (rows 64 wg .. 64 wg + 63 of each tile): for slab
  // v they queue its products (split stage v % kSplitStages) and wait for
  // them, then load slab v + 1's A fragments (the tensor cores meanwhile
  // run the other warpgroup's products) and mark slab v done; at the end
  // of an item they store its tile.
  float acc[T::kAcc];
  uint32_t a_hi[kTcKSteps][4], a_lo[kTcKSteps][4];
  const int frag_row = 64 * wg + 16 * warp + lane / 4, frag_col = lane % 4;
  // the B planes of split stage 0; a descriptor moves by (bytes >> 4): 32
  // bytes a k-step, a plane, a stage
  const uint64_t db0 = kmajor_desc(base);
  constexpr uint64_t kStageD = T::kSplit >> 4, kLoD = T::kBPlane >> 4;
  auto fence_frags = [&]() {
#pragma unroll
    for (int kk = 0; kk < kTcKSteps; ++kk) {
      fence_regs(a_hi[kk]);
      fence_regs(a_lo[kk]);
    }
  };
  auto mma = [&](int v) {
    const uint64_t db = db0 + (v % kSplitStages) * kStageD;
    fence_regs(acc);
    fence_frags();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcKSteps; ++kk) {
      const uint64_t b_hi = db + 2 * kk;
      wgmma_tf32<BN>(acc, a_lo[kk], b_hi);          // lo * hi
      wgmma_tf32<BN>(acc, a_hi[kk], b_hi + kLoD);   // hi * lo
      wgmma_tf32<BN>(acc, a_hi[kk], b_hi);          // hi * hi
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags();
  };
  auto frags = [&](int v) {
    bar_sync(kBarReady + v % kSplitStages, kTcThreads);
    TcSlab<BN>::frags(raw(v), frag_row, frag_col, a_hi, a_lo);
    bar_arrive(done_bar(v - 1), kTcThreads);
  };

  const bool partial = splits > 1;
  // acc[4 j + 2 h + e] is (row + 8 h, n0 + 8 j + col_t + e)
  const int row_t = 64 * wg + 16 * warp + lane / 4, col_t = 2 * (lane % 4);
  frags(0);
  int v = 0;
  for (int64_t w = blockIdx.x; w < items; w += gridDim.x) {
    const TcWork it = work(w);
#pragma unroll
    for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.f;
    for (int s = 0; s < it.n_slabs; ++s, ++v) {
      mma(v);
      if (v + 1 < total) frags(v + 1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gm = it.m0 + row_t + 8 * h;
      if (gm >= M) continue;
      float* crow = it.c + gm * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int64_t gn = it.n0 + 8 * j + col_t;
        if (gn >= N) continue;   // N is even: gn + 1 < N too
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (!partial) {
          if (bias != nullptr) {
            v0 += bias[it.g * bias_stride + gn];
            v1 += bias[it.g * bias_stride + gn + 1];
          }
          if (relu) {            // NaN passes, as torch.relu
            if (v0 < 0.f) v0 = 0.f;
            if (v1 < 0.f) v1 = 0.f;
          }
        }
        *reinterpret_cast<float2*>(crow + gn) = make_float2(v0, v1);
      }
    }
  }
}

// K2, and K1 over im2col patches: A a row-major (G, M, K) array.
template <int BN>
__global__ void __launch_bounds__(kTcThreads, 1)
gemm_tc_kernel(const float* __restrict__ A, const float* __restrict__ B,
               const float* __restrict__ bias, float* __restrict__ C,
               int64_t G, int64_t M, int64_t K, int64_t N,
               int64_t bias_stride, int64_t tiles_m, int64_t tiles_n,
               int64_t splits, int64_t k_chunk, int relu, int ws) {
  tc_gemm<BN>(DenseA{A}, B, bias, C, G, M, K, N, bias_stride, tiles_m,
              tiles_n, splits, k_chunk, relu, ws);
}

// K1 over the map itself (G = 1): the same body, its A chunks read from
// the NHWC map where the patch matrix would have them.
template <int BN>
__global__ void __launch_bounds__(kTcThreads, 1)
conv_tc_kernel(const ConvA A, const float* __restrict__ B,
               const float* __restrict__ bias, float* __restrict__ C,
               int64_t G, int64_t M, int64_t K, int64_t N,
               int64_t bias_stride, int64_t tiles_m, int64_t tiles_n,
               int64_t splits, int64_t k_chunk, int relu, int ws) {
  tc_gemm<BN>(A, B, bias, C, G, M, K, N, bias_stride, tiles_m, tiles_n,
              splits, k_chunk, relu, ws);
}

// the entry of each A source, and what it takes as A
template <int BN>
auto tc_entry(const DenseA&) { return gemm_tc_kernel<BN>; }
template <int BN>
auto tc_entry(const ConvA&) { return conv_tc_kernel<BN>; }
inline const float* tc_arg(const DenseA& src) { return src.a; }
inline const ConvA& tc_arg(const ConvA& src) { return src; }

// ---------------------------------------------------------------------------
// Plans and dispatch
// ---------------------------------------------------------------------------

enum class Tile { kWide, kNarrow, kSkinny, kTc64, kTc128 };
enum Route { kRouteFma = 0, kRouteFmaSplitK = 1, kRouteTc = 2 };

struct Plan {
  Tile tile;
  int64_t bm, bn, bk;
  int64_t splits, k_chunk;
};

int sm_count(int device) {
  static int counts[64] = {0};
  const int slot = device >= 0 && device < 64 ? device : 0;
  if (counts[slot] == 0) {
    int count = 0;
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    counts[slot] = count > 0 ? count : 1;
  }
  return counts[slot];
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

void set_chunk(Plan& p, int64_t K, int64_t splits) {
  p.k_chunk = K > 0 ? cdiv(cdiv(K, splits), p.bk) * p.bk : p.bk;
  p.splits = K > 0 ? cdiv(K, p.k_chunk) : 1;
}

// FMA body: tile shape and K split. Split K only when the output tiles
// cannot fill the card, and keep at least 8 slabs per split.
Plan plan_fma(int64_t G, int64_t M, int64_t K, int64_t N, int64_t sms) {
  Plan p;
  if (M <= 16) {
    p = {Tile::kSkinny, 16, 64, 32, 1, 0};
  } else if (N > 64 && G * cdiv(M, 128) * cdiv(N, 128) >= 2 * sms) {
    p = {Tile::kWide, 128, 128, 8, 1, 0};
  } else {
    p = {Tile::kNarrow, 128, 64, 16, 1, 0};
  }
  const int64_t tiles = G * cdiv(M, p.bm) * cdiv(N, p.bn);
  int64_t splits = 1;
  if (tiles < sms && K > 0) {
    const int64_t max_splits = K / (8 * p.bk) > 1 ? K / (8 * p.bk) : 1;
    splits = cdiv(4 * sms, tiles);
    if (splits > max_splits) splits = max_splits;
  }
  set_chunk(p, K, splits);
  return p;
}

// Tensor-core body: BN 64 where N <= 64, else 128. A block is one per SM,
// so with fewer tiles than SMs K is split into the count that costs the
// fewest slabs per SM (waves of blocks x slabs a block; the fewest splits
// on a tie), with at least 8 slabs per split.
Plan plan_tc(int64_t G, int64_t M, int64_t K, int64_t N, int64_t sms) {
  Plan p = N <= 64 ? Plan{Tile::kTc64, kTcBM, 64, kTcBK, 1, 0}
                   : Plan{Tile::kTc128, kTcBM, 128, kTcBK, 1, 0};
  const int64_t tiles = G * cdiv(M, p.bm) * cdiv(N, p.bn);
  int64_t splits = 1;
  if (tiles < sms) {
    const int64_t max_splits = K / (8 * kTcBK) > 1 ? K / (8 * kTcBK) : 1;
    int64_t best = cdiv(K, kTcBK);
    for (int64_t s = 2; s <= max_splits; ++s) {
      const int64_t cost = cdiv(tiles * s, sms) * cdiv(cdiv(K, s), kTcBK);
      if (cost < best) {
        best = cost;
        splits = s;
      }
    }
  }
  set_chunk(p, K, splits);
  return p;
}

bool tc_shape(int64_t M, int64_t K, int64_t N) {
  return M >= 64 && K > 0 && K % 4 == 0 && N % 4 == 0;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The route of a call: shape and alignment alone.
bool takes_tc(const void* A, const void* B, const void* C,
              const void* workspace, int64_t M, int64_t K, int64_t N) {
  return tc_shape(M, K, N) && aligned16(A) && aligned16(B) && aligned16(C) &&
         (workspace == nullptr || aligned16(workspace));
}

Plan plan_gemm(bool tc, int64_t G, int64_t M, int64_t K, int64_t N,
               int device) {
  const int64_t sms = sm_count(device);
  return tc ? plan_tc(G, M, K, N, sms) : plan_fma(G, M, K, N, sms);
}

// Second pass of a split plan, after its first.
cudaError_t launch_reduce(const Plan& p, const float* bias, float* C,
                          const float* workspace, int64_t G, int64_t M,
                          int64_t N, int64_t bias_stride, int relu,
                          cudaStream_t stream) {
  const int64_t plane = G * M * N;
  if (cdiv(plane, 256) > INT32_MAX) return cudaErrorInvalidConfiguration;
  splitk_reduce_kernel<<<static_cast<unsigned>(cdiv(plane, 256)), 256, 0,
                         stream>>>(workspace, bias, C, p.splits, plane, M * N,
                                   N, bias_stride, relu);
  return cudaGetLastError();
}

cudaError_t check_grid(const Plan& p, int64_t G, int64_t M, int64_t N,
                       const float* workspace) {
  if (cdiv(M, p.bm) * cdiv(N, p.bn) > INT32_MAX || G > 65535 ||
      p.splits > 65535)
    return cudaErrorInvalidConfiguration;
  if (p.splits > 1 && workspace == nullptr) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int BM, int BN, int BK, int TM, int TN>
cudaError_t launch_plan(const Plan& p, bool vec, const float* A,
                        const float* B, const float* bias, float* C,
                        float* workspace, int64_t G, int64_t M, int64_t K,
                        int64_t N, int64_t bias_stride, int64_t relu,
                        int64_t ws, cudaStream_t stream) {
  cudaError_t err = check_grid(p, G, M, N, workspace);
  if (err != cudaSuccess) return err;
  const int64_t tiles_m = cdiv(M, BM), tiles_n = cdiv(N, BN);
  const bool split = p.splits > 1;
  const dim3 grid(static_cast<unsigned>(tiles_m * tiles_n),
                  static_cast<unsigned>(G),
                  static_cast<unsigned>(p.splits));
  constexpr int threads = Shape<BM, BN, BK, TM, TN>::NT;
  float* out = split ? workspace : C;
  const int r = static_cast<int>(relu != 0), w = static_cast<int>(ws != 0);
  if (vec)
    gemm_f32_kernel<BM, BN, BK, TM, TN, true><<<grid, threads, 0, stream>>>(
        A, B, bias, out, M, K, N, bias_stride, tiles_m, tiles_n, p.k_chunk,
        r, w);
  else
    gemm_f32_kernel<BM, BN, BK, TM, TN, false><<<grid, threads, 0, stream>>>(
        A, B, bias, out, M, K, N, bias_stride, tiles_m, tiles_n, p.k_chunk,
        r, w);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  return launch_reduce(p, bias, C, workspace, G, M, N, bias_stride, r,
                       stream);
}

template <int BN, class Src>
cudaError_t launch_tc(const Plan& p, const Src& A, const float* B,
                      const float* bias, float* C, float* workspace,
                      int64_t G, int64_t M, int64_t K, int64_t N,
                      int64_t bias_stride, int64_t relu, int64_t ws,
                      cudaStream_t stream) {
  cudaError_t err = check_grid(p, G, M, N, workspace);
  if (err != cudaSuccess) return err;
  constexpr int smem = TcTile<BN>::kSmem;
  auto kernel = tc_entry<BN>(A);
  // once per device and entry (the launch is on the caller's device, set
  // above)
  static bool attr_set[64] = {false};
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device >= 0 && device < 64;
  if (!cached || !attr_set[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    if (cached) attr_set[device] = true;
  }
  const int64_t tiles_m = cdiv(M, kTcBM), tiles_n = cdiv(N, BN);
  const bool split = p.splits > 1;
  // persistent blocks, one per SM at most
  const int64_t items = tiles_m * tiles_n * G * p.splits;
  const int64_t sms = sm_count(device);
  const unsigned blocks = static_cast<unsigned>(items < sms ? items : sms);
  const int r = static_cast<int>(relu != 0), w = static_cast<int>(ws != 0);
  kernel<<<blocks, kTcThreads, smem, stream>>>(
      tc_arg(A), B, bias, split ? workspace : C, G, M, K, N, bias_stride,
      tiles_m, tiles_n, p.splits, p.k_chunk, r, w);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  return launch_reduce(p, bias, C, workspace, G, M, N, bias_stride, r,
                       stream);
}

cudaError_t gemm_dispatch(const float* A, const float* B, const float* bias,
                          float* C, float* workspace, int64_t G, int64_t M,
                          int64_t K, int64_t N, int64_t bias_stride,
                          int64_t relu, int64_t ws, int64_t device,
                          cudaStream_t stream) {
  if (G <= 0 || M <= 0 || N <= 0 || K < 0) return cudaErrorInvalidValue;
  // launch on the device of the caller's stream, whatever this runtime's
  // current device is
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  const bool tc = takes_tc(A, B, C, workspace, M, K, N);
  const Plan p = plan_gemm(tc, G, M, K, N, static_cast<int>(device));
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned16(A) &&
                   aligned16(B) && aligned16(C) &&
                   (workspace == nullptr || aligned16(workspace));
  switch (p.tile) {
    case Tile::kTc64:
      return launch_tc<64>(p, DenseA{A}, B, bias, C, workspace, G, M, K, N,
                           bias_stride, relu, ws, stream);
    case Tile::kTc128:
      return launch_tc<128>(p, DenseA{A}, B, bias, C, workspace, G, M, K, N,
                            bias_stride, relu, ws, stream);
    case Tile::kSkinny:
      return launch_plan<16, 64, 32, 4, 4>(p, vec, A, B, bias, C, workspace,
                                           G, M, K, N, bias_stride, relu, ws,
                                           stream);
    case Tile::kWide:
      return launch_plan<128, 128, 8, 8, 8>(p, vec, A, B, bias, C, workspace,
                                            G, M, K, N, bias_stride, relu, ws,
                                            stream);
    default:
      return launch_plan<128, 64, 16, 8, 4>(p, vec, A, B, bias, C, workspace,
                                            G, M, K, N, bias_stride, relu, ws,
                                            stream);
  }
}

// K1 over the map itself: the tensor-core route only, where it would take
// the patch GEMM (takes_tc) and the map's chunks are 16-byte aligned: C and
// the strides multiples of 4 (kernels/spatial_conv/kernel.py's
// takes_implicit, the same rule). The plan is the patch GEMM's, so every
// sum runs in the same order and the output is conv_gemm_f32's over the
// im2col patches, bit for bit.
cudaError_t conv_implicit_dispatch(const ConvA& a, const float* W,
                                   const float* bias, float* C,
                                   float* workspace, int64_t n, int64_t r,
                                   int64_t N, int64_t relu, int64_t ws,
                                   int64_t device, cudaStream_t stream) {
  const int64_t M = n * a.ho * a.wo, K = r * a.s * a.c;
  if (a.c % 4 != 0 || a.sn % 4 != 0 || a.sh % 4 != 0 || a.sw % 4 != 0 ||
      !takes_tc(a.x, W, C, workspace, M, K, N))
    return cudaErrorInvalidValue;
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  const Plan p = plan_gemm(true, 1, M, K, N, static_cast<int>(device));
  if (p.tile == Tile::kTc64)
    return launch_tc<64>(p, a, W, bias, C, workspace, 1, M, K, N, 0, relu,
                         ws, stream);
  return launch_tc<128>(p, a, W, bias, C, workspace, 1, M, K, N, 0, relu, ws,
                        stream);
}

}  // namespace

extern "C" {

// Floats of workspace a (G, M, K, N) GEMM needs (0 when K is not split);
// the caller allocates it and passes it to conv_gemm_f32 / bmm_f32. The
// route also depends on the pointers' alignment, so this covers both.
int64_t gemm_f32_workspace(int64_t g, int64_t m, int64_t k, int64_t n,
                           int64_t device) {
  if (g <= 0 || m <= 0 || n <= 0 || k < 0) return 0;
  int64_t size = 0;
  for (int route = 0; route < 2; ++route) {
    const bool tc = route == 1;
    if (tc && !tc_shape(m, k, n)) continue;
    const Plan p = plan_gemm(tc, g, m, k, n, static_cast<int>(device));
    const int64_t need = p.splits > 1 ? p.splits * g * m * n : 0;
    if (need > size) size = need;
  }
  return size;
}

// The route conv_gemm_f32 / bmm_f32 take for these operands and sizes:
// 0 "fma", 1 "fma_splitk", 2 "tc3xtf32" (split K or not).
int gemm_f32_route(const void* a, const void* b, const void* out,
                   const void* workspace, int64_t g, int64_t m, int64_t k,
                   int64_t n, int64_t device) {
  if (takes_tc(a, b, out, workspace, m, k, n)) return kRouteTc;
  const Plan p = plan_gemm(false, g, m, k, n, static_cast<int>(device));
  return p.splits > 1 ? kRouteFmaSplitK : kRouteFma;
}

// K1: Y (T, K) = P (T, CRS) @ W (CRS, K) + bias (K) [ReLU]. bias may be null.
int conv_gemm_f32(const float* patches, const float* weights,
                  const float* bias, float* out, float* workspace, int64_t t,
                  int64_t crs, int64_t k, int64_t relu, int64_t ws,
                  int64_t device, void* stream) {
  return static_cast<int>(gemm_dispatch(patches, weights, bias, out,
                                        workspace, 1, t, crs, k, 0, relu, ws,
                                        device,
                                        static_cast<cudaStream_t>(stream)));
}

// K1 over the map itself (implicit GEMM): Y (N HO WO, K) = the patches of
// x (N, H, W, C; strides sn, sh, sw in floats, channels contiguous) @ W
// (R S C, K) + bias (K) [ReLU], taps at (oh stride - pad_top + r, ow
// stride - pad_left + s); a tap outside the map reads 0, so the bottom and
// right pads follow from HO and WO. bias may be null. Refused
// (cudaErrorInvalidValue) where conv_implicit_dispatch's rule fails.
int conv_implicit_f32(const float* x, const float* weights, const float* bias,
                      float* out, float* workspace, int64_t sn, int64_t sh,
                      int64_t sw, int64_t n, int64_t h, int64_t w, int64_t c,
                      int64_t k, int64_t r, int64_t s, int64_t stride,
                      int64_t pad_top, int64_t pad_left, int64_t ho,
                      int64_t wo, int64_t relu, int64_t ws, int64_t device,
                      void* stream) {
  // the geometry fits the kernel's 32-bit index arithmetic
  constexpr int64_t kMax = INT32_MAX / 4;
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || k <= 0 || r <= 0 || s <= 0 ||
      stride <= 0 || ho <= 0 || wo <= 0 || pad_top < 0 || pad_left < 0 ||
      h > kMax || w > kMax || r * s * c > kMax || n * ho * wo > kMax ||
      (ho - 1) * stride + r > kMax || (wo - 1) * stride + s > kMax ||
      pad_top > kMax || pad_left > kMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvA a{x,
                sn,
                sh,
                sw,
                static_cast<int>(h),
                static_cast<int>(w),
                static_cast<int>(c),
                static_cast<int>(s),
                static_cast<int>(stride),
                static_cast<int>(pad_top),
                static_cast<int>(pad_left),
                static_cast<int>(ho),
                static_cast<int>(wo)};
  return static_cast<int>(conv_implicit_dispatch(
      a, weights, bias, out, workspace, n, r, k, relu, ws, device,
      static_cast<cudaStream_t>(stream)));
}

// K2: C (G, M, N) = A (G, M, K) @ B (G, K, N) + bias (G, N) [ReLU].
// bias may be null.
int bmm_f32(const float* a, const float* b, const float* bias, float* out,
            float* workspace, int64_t g, int64_t m, int64_t k, int64_t n,
            int64_t relu, int64_t ws, int64_t device, void* stream) {
  return static_cast<int>(gemm_dispatch(a, b, bias, out, workspace, g, m, k,
                                        n, n, relu, ws, device,
                                        static_cast<cudaStream_t>(stream)));
}

const char* hybriddnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
