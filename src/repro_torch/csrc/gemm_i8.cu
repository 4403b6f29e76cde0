// K5 qmm_i8: int8 x int8 GEMM with exact int32 accumulation and the fused
// requantize epilogue.
//
// Replaces
//   K5  src/repro/kernels/gemm/int8.py :: _qmm (body _qmm_kernel)
//       (A (M, K) int8 @ B (K, N) int8 -> int32, + bias (N) int32, optional
//       ReLU, clip(round(acc * mult[n]), -127, 127) -> (M, N) int8; the int8
//       PE behind every quantized CONV (im2col patches) and FC layer)
//
// What bounds it on an H100: the int8 tensor cores do 1979 TOP/s, about 590
// operations a byte of HBM at 3.35 TB/s. A conv GEMM does 2 K operations
// per output byte but reads its im2col patches (M x K bytes) once, so at
// K >= 576 and N <= 512 it sits near that ridge: VGG16's twelve tensor-core
// calls need 0.12 ms of operations and about 0.28 ms of bytes a request, so
// bytes bound them. The FC layers at batch 8 use every weight byte 8 times
// and are bound by the bytes of the weight matrix, on any pipe.
//
// Route "tc_s8" (M >= 64, K and N multiples of 16, 16-byte aligned
// operands and workspace: every main-path CONV GEMM but the 3-channel stems'
// K = 27). s8 wgmma (m64nBNk32, int32 accumulators in registers) takes both
// operands from shared memory, K-major only. A (the patches, row-major
// M x K) already is; B (the HWIO weights, (K, N), N-major) is not, so a
// first pass transposes it into the workspace, Bt (N, K), once per call
// (at most 2.4 MB, VGG16's conv8-9: microseconds). After that nothing is
// staged through registers: persistent blocks of 384 threads, one per SM,
// walk output tiles of 128 x BN (BN 128, or 64 where N <= 64) and their K in
// 128-byte slabs (one swizzled row, four k32 steps), one stream of slabs
// across the tiles.
// - One producer warpgroup copies each slab of A (128 x 128 bytes) and Bt
//   (BN x 128) with cp.async straight into a ring of five 128-byte-swizzled
//   stages, three slabs ahead; rows past M or N and bytes past the K chunk
//   are zero-filled (zero bytes add nothing to an integer sum), so ragged
//   edges need no padding.
// - Two consumer warpgroups (64 rows each) issue four wgmmas a slab and
//   keep one slab's group in flight while they wait for the next; at the end
//   of a tile they requantize it in registers, straight from the fragment
//   layout, and store it while the producers already fill the next tile's
//   slabs.
// - Named barriers hand the slabs over: the producers mark a slab ready
//   (its copies landed and fenced for the async proxy), the consumers mark
//   it done (its products finished), and a stage is refilled only after
//   the mark that frees it. 161 KB of shared memory (BN 128);
//   `python -m repro_torch.kernels.gemm.breakdown` prices the parts.
//
// Routes "dp4a" and "dp4a_bytes" (the M = 8 FC layers, K = 27, misaligned
// operands, any other shape): the blocked GEMM of gemm_f32.cu's FMA body
// on the integer pipes. Each block owns a BM x BN output tile and walks K
// in BK-deep slabs, double-buffered in shared memory with a register
// prefetch of the next slab. Shared memory holds K packed four to a 32-bit
// word: As[k/4][m] is the word of A's row m (four consecutive K bytes,
// exactly as they lie in memory) and Bs[k/4][n] the word of B's column n,
// assembled from four rows of B with __byte_perm (a 4 x 4 byte transpose
// per thread). Every inner step is one __dp4a per output element: four int8
// products summed into an int32 accumulator, so the __dp4a issue rate bounds
// this body (about a fifteenth of the tensor cores' rate). Where K and N
// are multiples of 4 and the operands 4-byte aligned the slabs move as
// 32-bit words ("dp4a"); other shapes take a byte-wise path ("dp4a_bytes").
// Ragged edges in M, N and K are masked.
//
// Every route: the epilogue adds bias[n] in int32, ReLU as max(acc, 0),
// __int2float_rn(acc) * mult[n] as one float32 multiply (__fmul_rn: never
// contracted), rintf (round half to even, like jnp.round), clamp to +-127,
// int8. When the output tiles cannot fill the card (the FC layers, VGG16's
// conv10-12, ResNet-18's stages 3-4), K is split across blocks that write
// int32 partial tiles to the caller-provided workspace; a second pass sums
// them and applies the same epilogue. Integer sums are exact in any order
// (|sum| <= K * 127**2 < 2**31), so every route is bit-identical to the
// plain version. The route depends on shape and alignment alone
// (qmm_i8_route names it); nothing falls back from one to another.
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

// ---------------------------------------------------------------------------
// Route tc_s8: s8 wgmma
// ---------------------------------------------------------------------------

constexpr int kTcBM = 128;        // output rows a tile: two warpgroups of 64
constexpr int kTcBK = 128;        // bytes of K a slab: one swizzled row
constexpr int kTcKSteps = kTcBK / 32;   // k32 steps of wgmma a slab
constexpr int kConsumers = 256;   // two warpgroups: the products and stores
constexpr int kProducers = 128;   // one warpgroup: the copies
constexpr int kTcThreads = kConsumers + kProducers;
constexpr int kStages = 5;        // slabs in the shared-memory ring
// slabs in flight: the consumers hold two stages (one slab's wgmmas still
// running while they issue the next one's), the copies the rest
constexpr int kCopyAhead = kStages - 2;
// named barriers (0 is __syncthreads): slab v's done and ready marks
constexpr int kBarDone = 1, kBarReady = kBarDone + kStages;
static_assert(kBarReady + kStages <= 16, "16 named barriers");

template <int BN>
struct TcTile {
  static constexpr int kAStage = kTcBM * kTcBK;   // bytes
  static constexpr int kBStage = BN * kTcBK;
  static constexpr int kStage = kAStage + kBStage;
  static constexpr int kSmem = kStages * kStage + 1024;   // + alignment
  static constexpr int kAcc = BN / 2;   // int32 accumulators a thread
  // 16-byte chunks a producer thread copies of every slab
  static constexpr int LA = kTcBM * (kTcBK / 16) / kProducers;
  static constexpr int LB = BN * (kTcBK / 16) / kProducers;
  static_assert(kStage % 1024 == 0, "stages keep the swizzle's alignment");
};

// One output tile of one split: a work item. Items run tile first, then
// split; consecutive tiles share A's row panel.
struct TcWork {
  int64_t m0, n0, k_begin, k_end, split;
  int n_slabs;
};

// Producer thread p's copies of the slab at k0 of item it into a stage:
// 16-byte chunk p % 8 of rows p / 8 + 16 l of A (128 x 128 bytes) and of Bt
// (BN x 128), swizzled; chunks past M, N or the item's K chunk are
// zero-filled (K is a multiple of 16, so a chunk is all in or all out).
template <int BN>
__device__ __forceinline__ void copy_slab(uint32_t stage, const int8_t* A,
                                          const int8_t* Bt, int64_t M,
                                          int64_t K, int64_t N,
                                          const TcWork& it, int64_t k0,
                                          int p) {
  using T = TcTile<BN>;
  constexpr int kRows = kProducers / 8;   // rows a pass of the producers
  const int row = p / 8, c = p % 8;
  const int64_t gk = k0 + c * 16;
  const bool k_ok = gk < it.k_end;
#pragma unroll
  for (int l = 0; l < T::LA; ++l) {
    const int r = row + l * kRows;
    const bool ok = k_ok && it.m0 + r < M;
    cp_async16(stage + swizzled(kTcBM, r, c),
               ok ? static_cast<const void*>(A + (it.m0 + r) * K + gk) : A,
               ok ? 16 : 0);
  }
#pragma unroll
  for (int l = 0; l < T::LB; ++l) {
    const int r = row + l * kRows;
    const bool ok = k_ok && it.n0 + r < N;
    cp_async16(stage + T::kAStage + swizzled(BN, r, c),
               ok ? static_cast<const void*>(Bt + (it.n0 + r) * K + gk) : Bt,
               ok ? 16 : 0);
  }
}

// A persistent block of 384 threads walks the work items blockIdx.x,
// blockIdx.x + gridDim.x, ...; its slabs, item after item, are one stream
// that the producers and consumers number the same way (v), so the ring
// runs on across items and one item's epilogue overlaps the next one's
// copies. With splits > 1 item (split, tile) writes its int32 partial
// product into part[split] (M x N). Every item has at least one slab (the
// plan keeps every split's chunk inside [0, K)).
template <int BN>
__global__ void __launch_bounds__(kTcThreads, 1)
qmm_tc_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
              const int32_t* __restrict__ bias,
              const float* __restrict__ mult, int8_t* __restrict__ C,
              int32_t* __restrict__ part, int64_t M, int64_t K, int64_t N,
              int64_t tiles_n, int64_t tiles, int64_t splits,
              int64_t k_chunk, int relu) {
  using T = TcTile<BN>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;

  // the warpgroup index broadcast from lane 0, so that the compiler knows
  // it is uniform across the warp and keeps the wgmmas asynchronous
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid % 128) / 32, lane = tid % 32;

  const int64_t items = tiles * splits;
  auto work = [&](int64_t w) {
    TcWork it;
    const int64_t tile = w % tiles;
    it.split = w / tiles;
    it.m0 = (tile / tiles_n) * kTcBM;
    it.n0 = (tile % tiles_n) * BN;
    it.k_begin = it.split * k_chunk;
    it.k_end = it.k_begin + k_chunk < K ? it.k_begin + k_chunk : K;
    it.n_slabs = static_cast<int>((it.k_end - it.k_begin + kTcBK - 1) /
                                  kTcBK);
    return it;
  };
  int total = 0;   // slabs of this block
  for (int64_t w = blockIdx.x; w < items; w += gridDim.x)
    total += work(w).n_slabs;
  auto stage = [&](int v) { return base + (v % kStages) * T::kStage; };

  // Producer warpgroup: slab j's copies go out once the consumers have
  // marked slab j - kStages (the stage's last tenant) done; once slab j's
  // copies have landed, kCopyAhead slabs later, the producers fence them
  // for the async proxy and mark slab j ready.
  if (wg == kConsumers / 128) {
    const int p = tid - kConsumers;
    int64_t w = blockIdx.x;
    int s = 0;
    TcWork it = work(w);
    for (int j = 0; j < total; ++j) {
      if (j >= kStages) bar_sync(kBarDone + j % kStages, kTcThreads);
      copy_slab<BN>(stage(j), A, Bt, M, K, N, it,
                    it.k_begin + static_cast<int64_t>(s) * kTcBK, p);
      cp_async_commit();
      if (++s == it.n_slabs) {
        s = 0;
        w += gridDim.x;
        if (w < items) it = work(w);
      }
      if (j >= kCopyAhead) {
        cp_async_wait<kCopyAhead>();
        fence_proxy_async();
        bar_arrive(kBarReady + (j - kCopyAhead) % kStages, kTcThreads);
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    for (int v = total > kCopyAhead ? total - kCopyAhead : 0; v < total; ++v)
      bar_arrive(kBarReady + v % kStages, kTcThreads);
    // the consumers' marks not waited for yet
    for (int v = total > kStages ? total - kStages : 0; v < total; ++v)
      bar_sync(kBarDone + v % kStages, kTcThreads);
    return;
  }

  // Consumer warpgroups (rows 64 wg .. 64 wg + 63 of each tile): for slab
  // v they wait for its mark, queue its four wgmmas, wait for slab v - 1's
  // and mark that one done; at the end of an item they requantize and
  // store its tile (or its int32 partial).
  int32_t acc[T::kAcc];
  // this warpgroup's rows of A, and Bt, in stage 0; a descriptor moves by
  // (bytes >> 4): 32 bytes a k32 step, a stage
  const uint64_t da0 = kmajor_desc(base + wg * 64 * kTcBK);
  const uint64_t db0 = kmajor_desc(base + T::kAStage);
  constexpr uint64_t kStageD = T::kStage >> 4;
  // acc[4 j + 2 h + e] is (row_t + 8 h, n0 + 8 j + col_t + e)
  const int row_t = 64 * wg + 16 * warp + lane / 4, col_t = 2 * (lane % 4);
  int v = 0;
  for (int64_t w = blockIdx.x; w < items; w += gridDim.x) {
    const TcWork it = work(w);
#pragma unroll
    for (int i = 0; i < T::kAcc; ++i) acc[i] = 0;
    for (int s = 0; s < it.n_slabs; ++s, ++v) {
      bar_sync(kBarReady + v % kStages, kTcThreads);
      const uint64_t off = (v % kStages) * kStageD;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcKSteps; ++kk)
        wgmma_s8<BN>(acc, da0 + off + 2 * kk, db0 + off + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      if (s > 0) bar_arrive(kBarDone + (v - 1) % kStages, kTcThreads);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    bar_arrive(kBarDone + (v - 1) % kStages, kTcThreads);

    int32_t* pp = part + it.split * M * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gm = it.m0 + row_t + 8 * h;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int64_t gn = it.n0 + 8 * j + col_t;
        if (gn >= N) continue;   // N is even: gn + 1 < N too
        const int32_t a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
        if (splits > 1) {
          *reinterpret_cast<int2*>(pp + gm * N + gn) = make_int2(a0, a1);
        } else {
          const uint8_t q0 = static_cast<uint8_t>(
              requantize(a0, bias[gn], mult[gn], relu));
          const uint8_t q1 = static_cast<uint8_t>(
              requantize(a1, bias[gn + 1], mult[gn + 1], relu));
          *reinterpret_cast<uint16_t*>(C + gm * N + gn) =
              static_cast<uint16_t>(q0 | (q1 << 8));
        }
      }
    }
  }
}

// Bt (N, K) = B (K, N) transposed, int8, K and N multiples of 16: the
// tc_s8 route's B operand, K-major. 64 x 64-byte tiles through shared
// memory, 16-byte loads and stores.
__global__ void __launch_bounds__(256)
transpose_i8_kernel(const int8_t* __restrict__ B, int8_t* __restrict__ Bt,
                    int64_t K, int64_t N) {
  __shared__ __align__(16) uint8_t tile[64][80];   // 64 rows of K, padded
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * 64;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * 64;
  const int r = threadIdx.x / 4, c = (threadIdx.x % 4) * 16;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (k0 + r < K && n0 + c < N)
    v = *reinterpret_cast<const uint4*>(B + (k0 + r) * N + n0 + c);
  *reinterpret_cast<uint4*>(&tile[r][c]) = v;
  __syncthreads();
  // this thread's row n0 + r of Bt, bytes k0 + c .. k0 + c + 15
  if (n0 + r >= N || k0 + c >= K) return;
  uint32_t word[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    word[q] = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      word[q] |= static_cast<uint32_t>(tile[c + 4 * q + i][r]) << (8 * i);
  }
  *reinterpret_cast<uint4*>(Bt + (n0 + r) * K + k0 + c) =
      make_uint4(word[0], word[1], word[2], word[3]);
}

// ---------------------------------------------------------------------------
// Plans and dispatch
// ---------------------------------------------------------------------------

enum class Tile { kWide, kNarrow, kSkinny, kTc64, kTc128 };
enum Route { kRouteDp4a = 0, kRouteDp4aBytes = 1, kRouteTc = 2 };

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

// dp4a body: tile shape and K split. Split K only when the output tiles
// cannot fill the card, and keep at least 8 slabs per split.
Plan plan_dp4a(int64_t M, int64_t K, int64_t N, int64_t sms) {
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
  set_chunk(p, K, splits);
  return p;
}

// Tensor-core body: BN 64 where N <= 64, else 128. A block is one per SM,
// so with fewer tiles than SMs K is split into the count that costs the
// fewest slabs per SM (waves of blocks x slabs a block; the fewest splits
// on a tie), with at least 4 slabs per split.
Plan plan_tc(int64_t M, int64_t K, int64_t N, int64_t sms) {
  Plan p = N <= 64 ? Plan{Tile::kTc64, kTcBM, 64, kTcBK, 1, 0}
                   : Plan{Tile::kTc128, kTcBM, 128, kTcBK, 1, 0};
  const int64_t tiles = cdiv(M, p.bm) * cdiv(N, p.bn);
  int64_t splits = 1;
  if (tiles < sms) {
    const int64_t slabs = cdiv(K, kTcBK);
    const int64_t max_splits = slabs / 4 > 1 ? slabs / 4 : 1;
    int64_t best = slabs;
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
  return M >= 64 && K > 0 && K % 16 == 0 && N % 16 == 0;
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The route of a call: shape and alignment alone.
bool takes_tc(const void* A, const void* B, const void* C,
              const void* workspace, int64_t M, int64_t K, int64_t N) {
  return tc_shape(M, K, N) && aligned(A, 16) && aligned(B, 16) &&
         aligned(C, 16) && (workspace == nullptr || aligned(workspace, 16));
}

bool vec_words(const void* A, const void* B, const void* C, int64_t K,
               int64_t N) {
  return K % 4 == 0 && N % 4 == 0 && aligned(A, 4) && aligned(B, 4) &&
         aligned(C, 4);
}

// int32 words of workspace a plan needs: the split partials, and for the
// tensor cores Bt after them
int64_t workspace_words(bool tc, const Plan& p, int64_t M, int64_t K,
                        int64_t N) {
  const int64_t partials = p.splits > 1 ? p.splits * M * N : 0;
  return tc ? partials + cdiv(N * K, 4) : partials;
}

// Second pass of a split plan, after its first.
cudaError_t launch_reduce(const Plan& p, const int32_t* bias,
                          const float* mult, int8_t* C,
                          const int32_t* workspace, int64_t M, int64_t N,
                          int relu, cudaStream_t stream) {
  const int64_t mn = M * N;
  if (cdiv(mn, 256) > INT32_MAX) return cudaErrorInvalidConfiguration;
  qmm_splitk_reduce_kernel<<<static_cast<unsigned>(cdiv(mn, 256)), 256, 0,
                             stream>>>(workspace, bias, mult, C, p.splits, mn,
                                       N, relu);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, int TM, int TN>
cudaError_t launch_plan(const Plan& p, bool vec, const int8_t* A,
                        const int8_t* B, const int32_t* bias,
                        const float* mult, int8_t* C, int32_t* workspace,
                        int64_t M, int64_t K, int64_t N, int relu,
                        cudaStream_t stream) {
  const int64_t tiles_m = cdiv(M, BM), tiles_n = cdiv(N, BN);
  if (tiles_m * tiles_n > INT32_MAX || p.splits > 65535)
    return cudaErrorInvalidConfiguration;
  const bool split = p.splits > 1;
  if (split && workspace == nullptr) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles_m * tiles_n), 1,
                  static_cast<unsigned>(p.splits));
  constexpr int threads = Shape<BM, BN, BK, TM, TN>::NT;
  if (vec)
    qmm_i8_kernel<BM, BN, BK, TM, TN, true><<<grid, threads, 0, stream>>>(
        A, B, bias, mult, C, workspace, M, K, N, tiles_n, p.k_chunk, relu);
  else
    qmm_i8_kernel<BM, BN, BK, TM, TN, false><<<grid, threads, 0, stream>>>(
        A, B, bias, mult, C, workspace, M, K, N, tiles_n, p.k_chunk, relu);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  return launch_reduce(p, bias, mult, C, workspace, M, N, relu, stream);
}

template <int BN>
cudaError_t launch_tc(const Plan& p, const int8_t* A, const int8_t* B,
                      const int32_t* bias, const float* mult, int8_t* C,
                      int32_t* workspace, int64_t M, int64_t K, int64_t N,
                      int relu, cudaStream_t stream) {
  if (workspace == nullptr) return cudaErrorInvalidValue;   // Bt lives there
  const int64_t tiles = cdiv(M, kTcBM) * cdiv(N, BN);
  if (cdiv(N, 64) > INT32_MAX || cdiv(K, 64) > 65535)
    return cudaErrorInvalidConfiguration;
  const bool split = p.splits > 1;
  int8_t* bt = reinterpret_cast<int8_t*>(workspace +
                                         (split ? p.splits * M * N : 0));
  transpose_i8_kernel<<<dim3(static_cast<unsigned>(cdiv(N, 64)),
                             static_cast<unsigned>(cdiv(K, 64))),
                        256, 0, stream>>>(B, bt, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem = TcTile<BN>::kSmem;
  auto kernel = qmm_tc_kernel<BN>;
  // once per device (the launch is on the caller's device, set above)
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
  // persistent blocks, one per SM at most
  const int64_t items = tiles * p.splits;
  const int64_t sms = sm_count(device);
  const unsigned blocks = static_cast<unsigned>(items < sms ? items : sms);
  kernel<<<blocks, kTcThreads, smem, stream>>>(
      A, bt, bias, mult, C, workspace, M, K, N, cdiv(N, BN), tiles, p.splits,
      p.k_chunk, relu);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  return launch_reduce(p, bias, mult, C, workspace, M, N, relu, stream);
}

}  // namespace

extern "C" {

// int32 words of workspace an (M, K, N) int8 GEMM needs (0 when the
// dp4a body does not split K); the caller allocates it and passes it to
// qmm_i8. The route also depends on the pointers' alignment, so this
// covers both bodies.
int64_t qmm_i8_workspace(int64_t m, int64_t k, int64_t n, int64_t device) {
  if (m <= 0 || n <= 0 || k < 0) return 0;
  const int64_t sms = sm_count(static_cast<int>(device));
  int64_t size = workspace_words(false, plan_dp4a(m, k, n, sms), m, k, n);
  if (tc_shape(m, k, n)) {
    const int64_t need = workspace_words(true, plan_tc(m, k, n, sms), m, k, n);
    if (need > size) size = need;
  }
  return size;
}

// The route qmm_i8 takes for these operands and sizes: 0 "dp4a", 1
// "dp4a_bytes", 2 "tc_s8" (split K or not).
int qmm_i8_route(const void* a, const void* b, const void* out,
                 const void* workspace, int64_t m, int64_t k, int64_t n) {
  if (takes_tc(a, b, out, workspace, m, k, n)) return kRouteTc;
  return vec_words(a, b, out, k, n) ? kRouteDp4a : kRouteDp4aBytes;
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
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const int64_t sms = sm_count(static_cast<int>(device));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(relu != 0);
  if (takes_tc(a, b, out, workspace, m, k, n)) {
    const Plan p = plan_tc(m, k, n, sms);
    const cudaError_t err =
        p.tile == Tile::kTc64
            ? launch_tc<64>(p, a, b, bias, mult, out, workspace, m, k, n, r, s)
            : launch_tc<128>(p, a, b, bias, mult, out, workspace, m, k, n, r,
                             s);
    return static_cast<int>(err);
  }
  const Plan p = plan_dp4a(m, k, n, sms);
  const bool vec = vec_words(a, b, out, k, n);
  cudaError_t err;
  switch (p.tile) {
    case Tile::kSkinny:
      err = launch_plan<16, 128, 64, 4, 4>(p, vec, a, b, bias, mult, out,
                                           workspace, m, k, n, r, s);
      break;
    case Tile::kWide:
      err = launch_plan<128, 128, 32, 8, 8>(p, vec, a, b, bias, mult, out,
                                            workspace, m, k, n, r, s);
      break;
    default:
      err = launch_plan<128, 64, 32, 8, 4>(p, vec, a, b, bias, mult, out,
                                           workspace, m, k, n, r, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
