// K5 qmm_i8: int8 x int8 GEMM with exact int32 accumulation and the fused
// requantize epilogue.
//
// Replaces
//   K5  src/repro/kernels/gemm/int8.py :: _qmm (body _qmm_kernel)
//       (A (M, K) int8 @ B (K, N) int8 -> int32, + bias (N) int32, optional
//       ReLU, clip(round(acc * mult[n]), -127, 127) -> (M, N) int8; the int8
//       PE behind every quantized CONV (im2col patches) and FC layer)
//
// What bounds it on an H100: the conv GEMMs of the int8 main path do
// 2*M*N*K integer operations on O(M*K + K*N + M*N) bytes, far above the
// ridge point even of the int8 tensor cores (1979 TOP/s over 3.35 TB/s ~ 590
// op/byte for K >= 576), so by the data sheet they are bound by operations;
// the FC layers at batch 8 use every weight byte 8 times and are bound by
// the bytes of the weight matrix. This first kernel does not reach the
// tensor cores: it runs on the integer pipes, so what bounds it in practice
// is the __dp4a issue rate, far below the bound above. IMMA / wgmma and TMA
// are later speed work.
//
// Design: the blocked GEMM of gemm_f32.cu with int8 operands. Each block owns
// a BM x BN output tile and walks K in BK-deep slabs, double-buffered in
// shared memory with a register prefetch of the next slab. Shared memory
// holds K packed four to a 32-bit word: As[k/4][m] is the word of A's row m
// (four consecutive K bytes, exactly as they lie in memory) and Bs[k/4][n]
// the word of B's column n, assembled from four rows of B with __byte_perm
// (a 4 x 4 byte transpose per thread). Every inner step is one __dp4a per
// output element: four int8 products summed into an int32 accumulator.
// Where K and N are multiples of 4 and the operands 4-byte aligned (every
// main-path GEMM but the 3-channel stem's K = 27) the slabs move as 32-bit
// words; other shapes take a byte-wise path. Ragged edges in M, N and K are
// masked (zero bytes contribute nothing to an integer sum), so nothing is
// padded.
//
// The epilogue runs in registers: add bias[n] in int32, ReLU as max(acc, 0),
// __int2float_rn(acc) * mult[n] as one float32 multiply (__fmul_rn: never
// contracted), rintf (round half to even, like jnp.round), clamp to +-127,
// store int8. When a GEMM has fewer output tiles than SMs (the FC layers,
// the last conv stage), K is split across blocks that write int32 partial
// tiles to a caller-provided workspace; a second pass sums them and applies
// the same epilogue. Integer sums are exact in any order, so the result is
// bit-identical to the unsplit kernel and to the plain version.
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
  static constexpr int KW = BK / 4;     // K words per slab
  static_assert(TM % 4 == 0 && TN % 4 == 0, "register tile in 4-wide groups");
  static_assert(BM % TM == 0 && BN % TN == 0, "register tile must divide");
  static_assert(BK % 16 == 0, "slab depth in 4-word steps");
};

// Moves one BK-deep slab of A (BM x BK of a row-major M x K) and B (BK x BN
// of a row-major K x N) from global memory into registers (load) and from
// there into the packed shared-memory words (store). Bytes outside
// [M) x [k_end) and [k_end) x [N) read as zero.
template <int BM, int BN, int BK, int TM, int TN, bool VEC>
struct Slab;

template <int BM, int BN, int BK, int TM, int TN>
struct Slab<BM, BN, BK, TM, TN, true> {       // 32-bit words
  using S = Shape<BM, BN, BK, TM, TN>;
  static constexpr int kA = BM * S::KW;           // A words
  static constexpr int kB = S::KW * (BN / 4);     // 4x4-byte blocks of B
  static constexpr int LA = (kA + S::NT - 1) / S::NT;
  static constexpr int LB = (kB + S::NT - 1) / S::NT;
  uint32_t ra[LA], rb[LB][4];

  __device__ __forceinline__ void load(const int8_t* A, const int8_t* B,
                                       int64_t M, int64_t K, int64_t N,
                                       int64_t m0, int64_t n0, int64_t k0,
                                       int64_t k_end, int tid) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int e = tid + l * S::NT;
      const int64_t gm = m0 + e / S::KW, gk = k0 + (e % S::KW) * 4;
      ra[l] = (e < kA && gm < M && gk < k_end)
                  ? *reinterpret_cast<const uint32_t*>(A + gm * K + gk)
                  : 0u;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int e = tid + l * S::NT;
      const int64_t gk = k0 + (e / (BN / 4)) * 4, gn = n0 + (e % (BN / 4)) * 4;
      const bool ok = e < kB && gk < k_end && gn < N;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rb[l][i] = ok ? *reinterpret_cast<const uint32_t*>(
                            B + (gk + i) * N + gn)
                      : 0u;
    }
  }

  __device__ __forceinline__ void store(uint32_t (*As)[BM + kAPad],
                                        uint32_t (*Bs)[BN], int tid) const {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int e = tid + l * S::NT;
      if (e < kA) As[e % S::KW][e / S::KW] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int e = tid + l * S::NT;
      if (e < kB) {
        // rb[l][i] holds B[k + i][n .. n + 3]; word j of the result holds
        // B[k .. k + 3][n + j] (byte i = row k + i), the order __dp4a pairs
        // with A's bytes
        const uint32_t t0 = __byte_perm(rb[l][0], rb[l][1], 0x5140);
        const uint32_t t1 = __byte_perm(rb[l][2], rb[l][3], 0x5140);
        const uint32_t t2 = __byte_perm(rb[l][0], rb[l][1], 0x7362);
        const uint32_t t3 = __byte_perm(rb[l][2], rb[l][3], 0x7362);
        *reinterpret_cast<uint4*>(&Bs[e / (BN / 4)][(e % (BN / 4)) * 4]) =
            make_uint4(__byte_perm(t0, t1, 0x5410),
                       __byte_perm(t0, t1, 0x7632),
                       __byte_perm(t2, t3, 0x5410),
                       __byte_perm(t2, t3, 0x7632));
      }
    }
  }
};

template <int BM, int BN, int BK, int TM, int TN>
struct Slab<BM, BN, BK, TM, TN, false> {      // byte-wise, any shape
  using S = Shape<BM, BN, BK, TM, TN>;
  static constexpr int kA = BM * S::KW, kB = S::KW * BN;   // words
  static constexpr int LA = (kA + S::NT - 1) / S::NT;
  static constexpr int LB = (kB + S::NT - 1) / S::NT;
  uint32_t ra[LA], rb[LB];

  __device__ __forceinline__ void load(const int8_t* A, const int8_t* B,
                                       int64_t M, int64_t K, int64_t N,
                                       int64_t m0, int64_t n0, int64_t k0,
                                       int64_t k_end, int tid) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int e = tid + l * S::NT;
      const int64_t gm = m0 + e / S::KW, gk = k0 + (e % S::KW) * 4;
      uint32_t w = 0;
      if (e < kA && gm < M) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (gk + i < k_end)
            w |= static_cast<uint32_t>(
                     static_cast<uint8_t>(A[gm * K + gk + i]))
                 << (8 * i);
      }
      ra[l] = w;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int e = tid + l * S::NT;
      const int64_t gk = k0 + (e / BN) * 4, gn = n0 + e % BN;
      uint32_t w = 0;
      if (e < kB && gn < N) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (gk + i < k_end)
            w |= static_cast<uint32_t>(
                     static_cast<uint8_t>(B[(gk + i) * N + gn]))
                 << (8 * i);
      }
      rb[l] = w;
    }
  }

  __device__ __forceinline__ void store(uint32_t (*As)[BM + kAPad],
                                        uint32_t (*Bs)[BN], int tid) const {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int e = tid + l * S::NT;
      if (e < kA) As[e % S::KW][e / S::KW] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int e = tid + l * S::NT;
      if (e < kB) Bs[e / BN][e % BN] = rb[l];
    }
  }
};

// acc -> int8: + bias, ReLU, one float32 multiply, round half to even,
// clamp. The same steps, in the same order, as the plain version.
__device__ __forceinline__ int8_t requantize(int32_t acc, int32_t bias,
                                             float mult, int relu) {
  acc += bias;
  if (relu && acc < 0) acc = 0;
  float y = rintf(__fmul_rn(__int2float_rn(acc), mult));
  y = fminf(fmaxf(y, -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(y));
}

// gridDim = (tiles_m * tiles_n, 1, splits). With splits > 1, block z
// computes the partial int32 product over K in [z * k_chunk,
// (z + 1) * k_chunk) into ws = the (splits, M, N) workspace.
template <int BM, int BN, int BK, int TM, int TN, bool VEC>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
qmm_i8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
              const int32_t* __restrict__ bias,
              const float* __restrict__ mult, int8_t* __restrict__ C,
              int32_t* __restrict__ ws, int64_t M, int64_t K, int64_t N,
              int64_t tiles_n, int64_t k_chunk, int relu) {
  using S = Shape<BM, BN, BK, TM, TN>;
  __shared__ __align__(16) uint32_t As[2][S::KW][BM + kAPad];
  __shared__ __align__(16) uint32_t Bs[2][S::KW][BN];

  const int64_t split = blockIdx.z;
  const int64_t tn = blockIdx.x % tiles_n, tm = blockIdx.x / tiles_n;
  const int64_t m0 = tm * BM, n0 = tn * BN;
  const int64_t k_begin = split * k_chunk;
  const int64_t k_end = k_begin + k_chunk < K ? k_begin + k_chunk : K;
  const int n_slabs = k_end > k_begin
                          ? static_cast<int>((k_end - k_begin + BK - 1) / BK)
                          : 0;
  const int tid = threadIdx.x;
  const int tx = tid % S::TX, ty = tid / S::TX;

  int32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

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
    for (int kk = 0; kk < S::KW; ++kk) {
      int32_t a[TM], b[TN];
#pragma unroll
      for (int gi = 0; gi < TM / 4; ++gi) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            &As[buf][kk][gi * S::RS + ty * 4]);
        a[gi * 4] = static_cast<int32_t>(v.x);
        a[gi * 4 + 1] = static_cast<int32_t>(v.y);
        a[gi * 4 + 2] = static_cast<int32_t>(v.z);
        a[gi * 4 + 3] = static_cast<int32_t>(v.w);
      }
#pragma unroll
      for (int hj = 0; hj < TN / 4; ++hj) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            &Bs[buf][kk][hj * S::CS + tx * 4]);
        b[hj * 4] = static_cast<int32_t>(v.x);
        b[hj * 4 + 1] = static_cast<int32_t>(v.y);
        b[hj * 4 + 2] = static_cast<int32_t>(v.z);
        b[hj * 4 + 3] = static_cast<int32_t>(v.w);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    if (more) slab.store(As[buf ^ 1], Bs[buf ^ 1], tid);
    __syncthreads();
  }

  const bool partial = gridDim.z > 1;
  int32_t* part = ws + split * M * N;
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
        if (partial) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (gn + c < N) part[gm * N + gn + c] = acc[i][hj * 4 + c];
          continue;
        }
        int8_t q[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          q[c] = gn + c < N ? requantize(acc[i][hj * 4 + c], bias[gn + c],
                                         mult[gn + c], relu)
                            : 0;
        if (VEC) {
          if (gn < N)
            *reinterpret_cast<uint32_t*>(C + gm * N + gn) =
                static_cast<uint32_t>(static_cast<uint8_t>(q[0])) |
                static_cast<uint32_t>(static_cast<uint8_t>(q[1])) << 8 |
                static_cast<uint32_t>(static_cast<uint8_t>(q[2])) << 16 |
                static_cast<uint32_t>(static_cast<uint8_t>(q[3])) << 24;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (gn + c < N) C[gm * N + gn + c] = q[c];
        }
      }
    }
  }
}

// Second pass of a split-K GEMM: C = requantize(sum over splits of the
// int32 partials + bias). One thread per output element.
__global__ void __launch_bounds__(256)
qmm_splitk_reduce_kernel(const int32_t* __restrict__ part,
                         const int32_t* __restrict__ bias,
                         const float* __restrict__ mult,
                         int8_t* __restrict__ C, int64_t splits, int64_t MN,
                         int64_t N, int relu) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= MN) return;
  int32_t acc = 0;
  for (int64_t s = 0; s < splits; ++s) acc += part[s * MN + idx];
  const int64_t n = idx % N;
  C[idx] = requantize(acc, bias[n], mult[n], relu);
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

// Tile shape and K split for an (M, K, N) GEMM. Split K only when the output
// tiles cannot fill the card, and keep at least 8 slabs per split.
Plan plan_qmm(int64_t M, int64_t K, int64_t N, int device) {
  const int64_t sms = sm_count(device);
  Plan p;
  if (M <= 16) {
    p = {Tile::kSkinny, 16, 128, 64, 1, 0};
  } else if (N > 64 && cdiv(M, 128) * cdiv(N, 128) >= 2 * sms) {
    p = {Tile::kWide, 128, 128, 32, 1, 0};
  } else {
    p = {Tile::kNarrow, 128, 64, 32, 1, 0};
  }
  const int64_t tiles = cdiv(M, p.bm) * cdiv(N, p.bn);
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
cudaError_t launch_plan(const Plan& p, bool vec, const int8_t* A,
                        const int8_t* B, const int32_t* bias,
                        const float* mult, int8_t* C, int32_t* workspace,
                        int64_t M, int64_t K, int64_t N, int64_t relu,
                        cudaStream_t stream) {
  const int64_t tiles_m = cdiv(M, BM), tiles_n = cdiv(N, BN);
  if (tiles_m * tiles_n > INT32_MAX || p.splits > 65535)
    return cudaErrorInvalidConfiguration;
  const bool split = p.splits > 1;
  if (split && workspace == nullptr) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles_m * tiles_n), 1,
                  static_cast<unsigned>(p.splits));
  constexpr int threads = Shape<BM, BN, BK, TM, TN>::NT;
  const int r = static_cast<int>(relu != 0);
  if (vec)
    qmm_i8_kernel<BM, BN, BK, TM, TN, true><<<grid, threads, 0, stream>>>(
        A, B, bias, mult, C, workspace, M, K, N, tiles_n, p.k_chunk, r);
  else
    qmm_i8_kernel<BM, BN, BK, TM, TN, false><<<grid, threads, 0, stream>>>(
        A, B, bias, mult, C, workspace, M, K, N, tiles_n, p.k_chunk, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  const int64_t mn = M * N;
  if (cdiv(mn, 256) > INT32_MAX) return cudaErrorInvalidConfiguration;
  qmm_splitk_reduce_kernel<<<static_cast<unsigned>(cdiv(mn, 256)), 256, 0,
                             stream>>>(workspace, bias, mult, C, p.splits, mn,
                                       N, r);
  return cudaGetLastError();
}

bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0;
}

}  // namespace

extern "C" {

// int32 words of workspace an (M, K, N) int8 GEMM needs (0 when K is not
// split); the caller allocates it and passes it to qmm_i8.
int64_t qmm_i8_workspace(int64_t m, int64_t k, int64_t n, int64_t device) {
  if (m <= 0 || n <= 0 || k < 0) return 0;
  const Plan p = plan_qmm(m, k, n, static_cast<int>(device));
  return p.splits > 1 ? p.splits * m * n : 0;
}

// K5: C (M, N) int8 = requantize(A (M, K) int8 @ B (K, N) int8 + bias (N)
// int32) with mult (N) float32 and optional ReLU.
int qmm_i8(const int8_t* a, const int8_t* b, const int32_t* bias,
           const float* mult, int8_t* out, int32_t* workspace, int64_t m,
           int64_t k, int64_t n, int64_t relu, int64_t device, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || bias == nullptr || mult == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // launch on the device of the caller's stream, whatever this runtime's
  // current device is
  const cudaError_t dev_err = cudaSetDevice(static_cast<int>(device));
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const Plan p = plan_qmm(m, k, n, static_cast<int>(device));
  const bool vec = k % 4 == 0 && n % 4 == 0 && aligned4(a) && aligned4(b) &&
                   aligned4(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (p.tile) {
    case Tile::kSkinny:
      err = launch_plan<16, 128, 64, 4, 4>(p, vec, a, b, bias, mult, out,
                                           workspace, m, k, n, relu, s);
      break;
    case Tile::kWide:
      err = launch_plan<128, 128, 32, 8, 8>(p, vec, a, b, bias, mult, out,
                                            workspace, m, k, n, relu, s);
      break;
    default:
      err = launch_plan<128, 64, 32, 8, 4>(p, vec, a, b, bias, mult, out,
                                           workspace, m, k, n, relu, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
