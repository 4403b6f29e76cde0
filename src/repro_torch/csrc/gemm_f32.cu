// K1 conv_gemm_f32 and K2 bmm_f32: one blocked fp32 GEMM body, two entries.
//
// Replaces
//   K1  src/repro/kernels/spatial_conv/kernel.py :: conv_gemm_kernel
//       (the Spatial-mode PE: (T, C*R*S) @ (C*R*S, K) + bias, optional ReLU)
//   K2  src/repro/kernels/gemm/kernel.py :: batched_matmul_kernel
//       ((G, M, K) @ (G, K, N), optional (G, N) bias + ReLU epilogue; the
//       PT^2-batched Winograd GEMM and, with G = 1, the FC layer)
//
// What bounds it on an H100: the conv GEMMs of the main path do 2*M*N*K
// flops on O(M*K + K*N + M*N) words, far above the fp32 ridge point
// (67 TFLOP/s over 3.35 TB/s ~ 20 flop/byte), so they are bound by fp32
// FMA throughput outside the tensor cores. The FC layers at batch 8 are the
// opposite: every weight word is used 8 times, so they are bound by the
// bytes of the weight matrix.
//
// Design: a shared-memory tiled SGEMM with fp32 FMA accumulation. Each
// block owns a BM x BN output tile and walks K in BK-deep slabs. Slabs are
// double-buffered in shared memory: while the block computes on one, each
// thread already holds the next slab's global loads in registers, so
// memory latency hides behind the FMAs and one barrier per slab suffices.
// A is stored k-major (transposed, padded so the store is free of bank
// conflicts); each thread keeps a TM x TN register tile made of 4-wide
// groups, read from shared memory as 16-byte vectors. Where K and N are
// multiples of 4 and the operands 16-byte aligned (every main-path GEMM but
// conv0's K = 27), global loads and stores are 16-byte vectors too; other
// shapes take a scalar path. Ragged edges in M, N and K are masked in the
// kernel, so the wrapper pads nothing.
//
// Three tile shapes: 128x128 for wide GEMMs with enough tiles to fill the
// card, 128x64 for narrow or few-tile GEMMs (conv0, the conv1 Winograd
// GEMM, conv10-12), and 16x64 for the skinny-M FC GEMMs. When a GEMM has
// fewer output tiles than SMs (conv10-12, the FC layers), K is split across
// blocks that write fp32 partial tiles to a caller-provided workspace, and
// a second pass sums the partials in split order (deterministic) and applies
// bias and ReLU; this is what keeps enough weight bytes in flight for the
// byte-bound FC layers. Bias and ReLU are otherwise fused at the store.
// Offsets are 64-bit. The IS/WS dataflow picks the raster order of output
// tiles (IS: consecutive blocks share an A row-panel; WS: a B column-panel)
// and changes no numbers.
#include <cuda_runtime.h>
#include <stdint.h>

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

enum class Tile { kWide, kNarrow, kSkinny };

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

// Tile shape and K split for a (G, M, K, N) GEMM. Split K only when the
// output tiles cannot fill the card, and keep at least 8 slabs per split.
Plan plan_gemm(int64_t G, int64_t M, int64_t K, int64_t N, int device) {
  const int64_t sms = sm_count(device);
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
  p.k_chunk = K > 0 ? cdiv(cdiv(K, splits), p.bk) * p.bk : p.bk;
  p.splits = K > 0 ? cdiv(K, p.k_chunk) : 1;
  return p;
}

template <int BM, int BN, int BK, int TM, int TN>
cudaError_t launch_plan(const Plan& p, bool vec, const float* A,
                        const float* B, const float* bias, float* C,
                        float* workspace, int64_t G, int64_t M, int64_t K,
                        int64_t N, int64_t bias_stride, int64_t relu,
                        int64_t ws, cudaStream_t stream) {
  const int64_t tiles_m = cdiv(M, BM), tiles_n = cdiv(N, BN);
  if (tiles_m * tiles_n > INT32_MAX || G > 65535 || p.splits > 65535)
    return cudaErrorInvalidConfiguration;
  const bool split = p.splits > 1;
  if (split && workspace == nullptr) return cudaErrorInvalidValue;
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
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  const int64_t plane = G * M * N;
  if (cdiv(plane, 256) > INT32_MAX) return cudaErrorInvalidConfiguration;
  splitk_reduce_kernel<<<static_cast<unsigned>(cdiv(plane, 256)), 256, 0,
                         stream>>>(workspace, bias, C, p.splits, plane, M * N,
                                   N, bias_stride, r);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

cudaError_t gemm_dispatch(const float* A, const float* B, const float* bias,
                          float* C, float* workspace, int64_t G, int64_t M,
                          int64_t K, int64_t N, int64_t bias_stride,
                          int64_t relu, int64_t ws, int64_t device,
                          cudaStream_t stream) {
  if (G <= 0 || M <= 0 || N <= 0 || K < 0) return cudaErrorInvalidValue;
  // launch on the device of the caller's stream, whatever this runtime's
  // current device is
  const cudaError_t dev_err = cudaSetDevice(static_cast<int>(device));
  if (dev_err != cudaSuccess) return dev_err;
  const Plan p = plan_gemm(G, M, K, N, static_cast<int>(device));
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned16(A) &&
                   aligned16(B) && aligned16(C) &&
                   (workspace == nullptr || aligned16(workspace));
  switch (p.tile) {
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

}  // namespace

extern "C" {

// Floats of workspace a (G, M, K, N) GEMM needs (0 when K is not split);
// the caller allocates it and passes it to conv_gemm_f32 / bmm_f32.
int64_t gemm_f32_workspace(int64_t g, int64_t m, int64_t k, int64_t n,
                           int64_t device) {
  if (g <= 0 || m <= 0 || n <= 0 || k < 0) return 0;
  const Plan p = plan_gemm(g, m, k, n, static_cast<int>(device));
  return p.splits > 1 ? p.splits * g * m * n : 0;
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
