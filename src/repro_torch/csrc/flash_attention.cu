// K6 flash_attention: online-softmax attention, fp32 statistics and P.
//
// Replaces
//   K6  src/repro/kernels/flash_attention/kernel.py :: flash_attention_kernel
//       (body _fa_kernel): O (BH, Sq, D) = softmax(Q K^T * scale) V over
//       Q (BH, Sq, D) and K, V (BH, Skv, D), fp32 running max, sum and
//       accumulator, an fp32 P in the P V product, a causal mask aligned at
//       the top left (row >= col), a kv_len mask on padded columns, -1e30 as
//       the masked value.
//
// Here K and V carry BH / group heads: query head bh reads KV head
// bh / group (GQA), so the repeated K/V of the reference's wrapper are never
// materialized. The causal mask takes a row offset: query row i sees the
// columns <= i + row_offset (0 is the reference kernel's mask; a chunk of a
// prompt past position 0, or a suffix appended to a cache, has its first
// position there). The output is written in the input type, rounded once.
//
// What bounds it on an H100: at the LM prefill shape (BH 64, Sq 4096, Skv
// 4112, D 128, causal) the useful work is 4 D operations per unmasked
// (row, col) pair, about 2.75e11, against 1.7e8 bytes of Q, K, V and O:
// far above the ridge point, so attention is bound by operations, 0.28 ms
// a layer at the bf16 tensor-core peak. Two bodies, chosen by dtype:
//
// bf16 (the LM prefill): the tensor cores, through wgmma. One block of two
// warpgroups per (head, 128-row Q tile), each warpgroup owning 64 query
// rows; Q tiles run from the last (longest causal rows) to the first, to
// balance the tail. The Q tile is loaded once; 64-row K and V tiles go
// through a three-stage ring in shared memory, filled by cp.async while
// the previous tiles are multiplied (TMA would need 16-byte row strides,
// which D = 7 does not have). Tiles are stored with the 128-byte swizzle the
// wgmma descriptors name, D zero-padded to 64 or 128 (zero columns add
// exactly 0). S = Q K^T is a bf16 wgmma (m64n64k16, A and B in shared
// memory) into fp32 registers: each product is exact and the sum is fp32.
// Scale, mask and the online-softmax update run on those registers; the
// row max and sum reduce over the four threads of a row with shuffles.
// P stays in registers as the A operand of O += P V (m64nDk16, V read
// MN-major through the transpose bit). The reference's P is fp32, which a
// bf16 product cannot take whole, so P is split into three bf16 terms,
// P1 = bf16(P), P2 = bf16(P - P1), P3 = bf16(P - P1 - P2), each multiplied
// by the same V tile into the fp32 accumulator: the three carry P's 24
// bits. Two terms (16 bits) leave 2**-17 of P, which moves short causal
// rows whose output is near 0 by more than one bf16 step of it
// (tests/test_torch_kernels.py shows both). The cost is 2x the useful
// tensor-core work (Q K^T plus three P V products for the two useful), so
// the bound this design can reach is 0.56 ms a layer. l sums the fp32 P.
//
// What bounds it in practice is latency, not the tensor cores' rate: each
// KV step runs Q K^T, then the softmax of its result on the CUDA cores,
// then P V, and a step's CUDA-core work (scale, max, exp, sum, the split,
// the rescale of O) is as long as its tensor-core work. So the design
// overlaps them. Each warpgroup queues S = Q K^T of step j, then the P V
// of step j - 1, and runs step j's softmax while that product is on the
// tensor cores. Queueing a step's products holds a warp until
// the tensor cores take most of them, so the two warpgroups take turns
// (a named barrier): warpgroup 0 queues first and runs its softmax while
// the tensor cores work through warpgroup 1's products. The copies of the
// next tile start after the products, not before; a step masks only
// where its tile crosses kv_len or the causal diagonal, with one 32-bit
// limit per row. The two warpgroups still meet at the ring's barrier once
// a step. Per thread: 64 fp32 of O, 32 of S and 48 registers of P terms
// (D 128); one block of 256 threads per SM, 129 KB of shared memory.
//
// fp32 (off the main path): fp32 FMAs, since the tensor cores take fp32
// only as TF32, which misses the 1e-4 the fp32 path is held to. One block
// of 256 threads per (head, 64-row Q block); the Q block sits in shared
// memory as fp32 for the whole KV sweep, each 64-row K and V block is
// staged beside it, a thread owns 4 rows x 4 columns of the score tile and
// its 4 x (64 or 128) slice of the output accumulator; P goes through
// shared memory for the P V product.
//
// Both bodies skip the KV blocks wholly above the causal diagonal: past
// block 0 they would add exactly 0, since column 0 is valid for every row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hopper_common.cuh"

namespace {

constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;  // the reference's masked value

// ---------------------------------------------------------------------------
// fp32 body: FMA pipes
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // KV rows per step
constexpr int kThreads = 256;      // 16 x 16: tx along columns, ty along rows
constexpr int kLdp = kBK + 4;      // row stride of the P tile

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ __forceinline__ int padded_d(int d) {
  return (d + 3) & ~3;
}

__host__ __device__ __forceinline__ int tile_ld(int d) {
  return padded_d(d) + 4;
}

// Floats of the K tile's region, which later holds the P tile.
__host__ __device__ __forceinline__ int k_region(int d) {
  const int ld = tile_ld(d);
  return kBK * (ld > kLdp ? ld : kLdp);
}

// rows [row0, row0 + 64) of a (rows, d) matrix -> a (64, ld) fp32 tile,
// zero past n_rows and past d. One warp per row at a time, lanes along d.
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int64_t row0, int64_t n_rows, int d,
                                          int dp, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const bool row_ok = row0 + r < n_rows;
    const float* s = src + (row0 + r) * d;
    for (int c = lane; c < dp; c += 32)
      dst[r * ld + c] = (row_ok && c < d) ? s[c] : 0.f;
  }
}

template <int NG>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int64_t group, int64_t sq, int64_t kv_len, int d,
                           int causal, int64_t row_offset, float scale,
                           int64_t skv) {
  constexpr int VW = 64 * NG;  // output columns a block covers
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dp = padded_d(d), ld = tile_ld(d);
  float* qs = smem;                  // (64, ld)
  float* ks = qs + kBQ * ld;         // (64, ld), then P (64, kLdp)
  float* vs = ks + k_region(d);      // (64, VW)
  float* ps = ks;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t bh = blockIdx.x;
  const int64_t q0 =
      static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kBQ;
  const float* kp = k + (bh / group) * skv * d;
  const float* vp = v + (bh / group) * skv * d;

  load_tile(qs, q + bh * sq * d, q0, sq, d, dp, ld);

  int64_t kv_end = kv_len;
  if (causal) {
    const int64_t last_row = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
    if (last_row + row_offset + 1 < kv_end) kv_end = last_row + row_offset + 1;
  }
  const int64_t n_kb = (kv_end + kBK - 1) / kBK;

  float m[4], l[4], acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  for (int64_t kb = 0; kb < n_kb; ++kb) {
    const int64_t c0 = kb * kBK;
    __syncthreads();  // the last step's P V is done with ps and vs
    load_tile(ks, kp, c0, kv_len, d, dp, ld);
    load_tile(vs, vp, c0, kv_len, d, VW, VW);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < dp; dd += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * ld + dd]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * ld + dd]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          s[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }

    // mask, then the online-softmax update of each of the thread's rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = c0 + tx + 16 * j;
        const bool ok = col < kv_len && (!causal || col <= row + row_offset);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = alpha * l[i] + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
    }

    __syncthreads();  // every thread is done reading the K tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * kLdp + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * i) * kLdp + kk]);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &vs[(kk + e4) * VW + 64 * g + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = e4 == 0   ? p4[i].x
                            : e4 == 1 ? p4[i].y
                            : e4 == 2 ? p4[i].z
                                      : p4[i].w;
            acc[i][g][0] = fmaf(p, vv.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(p, vv.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(p, vv.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(p, vv.w, acc[i][g][3]);
          }
        }
      }
    }
  }

  // flush acc / l, as the reference does at its last KV block
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    float* orow = o + (bh * sq + row) * d;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * g + tx * 4 + e;
        if (col < d) orow[col] = acc[i][g][e] / l[i];
      }
  }
}

template <int NG>
cudaError_t launch_fa_f32(const void* q, const void* k, const void* v, void* o,
                          int64_t bh, int64_t group, int64_t sq, int64_t skv,
                          int d, int64_t kv_len, int causal,
                          int64_t row_offset, float scale,
                          cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kBQ * tile_ld(d) + k_region(d) + kBK * 64 * NG);
  auto kernel = flash_attention_f32_kernel<NG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((sq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), group, sq, kv_len,
      d, causal, row_offset, scale, skv);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 body: wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTileQ = 128;              // query rows per block
constexpr int kTileKV = 64;              // KV rows per step
constexpr int kStages = 3;               // K/V ring in shared memory
constexpr int kWarpgroup = 128;          // threads of one warpgroup
constexpr int kTcThreads = 2 * kWarpgroup;
constexpr int kPSteps = kTileKV / 16;    // k16 steps of P V

// The V tile as the B operand of P V, MN-major (D contiguous): 8 KV rows
// (along K) 1024 bytes apart, 64-column halves of D kTileKV * 128 apart.
__device__ __forceinline__ uint64_t vtile_desc(uint32_t addr) {
  return smem_desc(addr, kTileKV * 128, 1024);
}

// D (64 x 64, fp32) (+)= A (64 x 16) B (16 x 64), A and B bf16 in shared
// memory, both K-major (128-byte swizzle).
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 in registers) B (16 x 64), B bf16
// in shared memory, MN-major (128-byte swizzle; the transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 in registers) B (16 x 128), B
// bf16 in shared memory, MN-major (128-byte swizzle; the transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_m64n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_m64n128(d, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float bf16_lo(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t bits) {
  return __uint_as_float(bits & 0xffff0000u);
}

// (x, y) -> three bf16x2 terms whose sum is (x, y) to fp32 precision: each
// term is the bf16 rounding of what the earlier ones leave, and each
// subtraction is exact.
__device__ __forceinline__ void split3(float x, float y, uint32_t& t1,
                                       uint32_t& t2, uint32_t& t3) {
  t1 = bf16x2_bits(x, y);
  x -= bf16_lo(t1);
  y -= bf16_hi(t1);
  t2 = bf16x2_bits(x, y);
  x -= bf16_lo(t2);
  y -= bf16_hi(t2);
  t3 = bf16x2_bits(x, y);
}

// rows [row0, row0 + ROWS) of a (n_rows, d) bf16 matrix into a swizzled
// (ROWS, DP) tile at shared address dst, zero past n_rows and past d. With
// vec (d % 8 == 0 and 16-byte aligned operands) each 16-byte chunk is one
// cp.async, zero-filled where masked; else the chunk is gathered and stored.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile_bf16(
    uint32_t dst, const __nv_bfloat16* __restrict__ src, int64_t row0,
    int64_t n_rows, int d, bool vec) {
  constexpr int kChunks = DP / 8;
  const unsigned short* bits = reinterpret_cast<const unsigned short*>(src);
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const uint32_t s = dst + swizzled(ROWS, r, c);
    const bool row_ok = row0 + r < n_rows;
    const int64_t at = (row0 + r) * d + c * 8;
    if (vec) {
      const bool ok = row_ok && c * 8 < d;
      cp_async16(s, ok ? static_cast<const void*>(src + at) : src,
                 ok ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c * 8 + 2 * j;
        const uint32_t lo = (row_ok && col < d) ? bits[at + 2 * j] : 0u;
        const uint32_t hi = (row_ok && col + 1 < d) ? bits[at + 2 * j + 1]
                                                    : 0u;
        w[j] = lo | (hi << 16);
      }
      st_shared_v4(s, w[0], w[1], w[2], w[3]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o, int64_t group,
                            int64_t sq, int64_t skv, int64_t kv_len, int d,
                            int causal, int64_t row_offset, float scale,
                            int vec) {
  constexpr int kQBytes = kTileQ * DP * 2;
  constexpr int kKVBytes = kTileKV * DP * 2;  // one K or one V tile
  constexpr int kSSteps = DP / 16;            // k16 steps of Q K^T
  constexpr int kNO = DP / 2;                 // O floats per thread
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                  // (128, DP)
  const uint32_t kv_s = base + kQBytes;       // stages of K (64, DP), V

  // the warpgroup index broadcast from lane 0: the compiler then knows it
  // (and every branch on it) is uniform across the warp, and keeps the
  // wgmma of the branches asynchronous instead of serializing them
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / kWarpgroup, 0);
  const int warp = (tid % kWarpgroup) / 32, lane = tid % 32;
  const int64_t bh = blockIdx.x;
  const int64_t q0 =
      static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kTileQ;
  const __nv_bfloat16* kp = k + (bh / group) * skv * d;
  const __nv_bfloat16* vp = v + (bh / group) * skv * d;

  int64_t kv_end = kv_len;
  if (causal) {
    const int64_t last_row = (q0 + kTileQ < sq ? q0 + kTileQ : sq) - 1;
    if (last_row + row_offset + 1 < kv_end) kv_end = last_row + row_offset + 1;
  }
  const int n_kb = static_cast<int>((kv_end + kTileKV - 1) / kTileKV);

  // K/V tile kb into its stage of the ring. With vec, this thread's chunks
  // sit in one 16-byte column c_t of rows r_t + j * kRowStep, so their
  // offsets are set up once, outside the loop.
  constexpr int kRowChunks = DP / 8;
  constexpr int kRowStep = kTcThreads / kRowChunks;
  constexpr int kKVPerThread = kTileKV / kRowStep;
  const int c_t = tid % kRowChunks, r_t = tid / kRowChunks;
  const uint32_t soff_t = swizzled(kTileKV, r_t, c_t);
  const int64_t goff_t = static_cast<int64_t>(r_t) * d + c_t * 8;
  const bool col_ok = c_t * 8 < d;
  auto load_kv = [&](int kb) {
    const uint32_t k_st = kv_s + (kb % kStages) * 2 * kKVBytes;
    const int64_t c0 = static_cast<int64_t>(kb) * kTileKV;
    if (vec) {
#pragma unroll
      for (int j = 0; j < kKVPerThread; ++j) {
        const bool ok = col_ok && c0 + r_t + j * kRowStep < kv_len;
        const int64_t at = c0 * d + goff_t + static_cast<int64_t>(j) *
                                                 kRowStep * d;
        const uint32_t so = soff_t + j * kRowStep * 128;
        cp_async16(k_st + so, ok ? static_cast<const void*>(kp + at) : kp,
                   ok ? 16 : 0);
        cp_async16(k_st + kKVBytes + so,
                   ok ? static_cast<const void*>(vp + at) : vp, ok ? 16 : 0);
      }
    } else {
      load_tile_bf16<kTileKV, DP>(k_st, kp, c0, kv_len, d, false);
      load_tile_bf16<kTileKV, DP>(k_st + kKVBytes, vp, c0, kv_len, d, false);
    }
    cp_async_commit();
  };
  load_tile_bf16<kTileQ, DP>(q_s, q + bh * sq * d, q0, sq, d, vec);
  load_kv(0);

  // this warpgroup's 64 rows; this thread's two, row_a and row_a + 8, and
  // its columns 8 j + col_t + {0, 1} of each 8-column group j
  const int64_t wg_row0 = q0 + 64 * wg;
  const bool wg_live = wg_row0 < sq;
  const int64_t row_a = wg_row0 + 16 * warp + lane / 4;
  const int col_t = 2 * (lane % 4);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) acc[i] = 0.f;
  float s[32];
  uint32_t pt[3][kPSteps][4];   // the three bf16 terms of P, as A

  // pins the thread's reads and writes of O and the P terms on their side
  // of a wgmma fence or wait
  auto fence_pv = [&]() {
    fence_regs(acc);
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk) fence_regs(pt[t][kk]);
  };
  // O += P1 V + P2 V + P3 V for the P terms in pt and the V tile at v_st;
  // a wgmma group of its own (its own fence), so that a wait for an
  // earlier group leaves it in flight
  auto start_pv = [&](uint32_t v_st) {
    fence_pv();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) {
      const uint64_t vd = vtile_desc(v_st + kk * 16 * 128);
#pragma unroll
      for (int t = 0; t < 3; ++t) wgmma_rs<DP>(acc, pt[t][kk], vd);
    }
    wgmma_commit();
  };

  // Step kb first waits for tile kb of the ring (and at kb 0 the Q tile);
  // once its products are queued it starts the copy of tile kb + 1. Stage
  // (kb + 1) % 3 last held tile kb - 2, whose P V every warpgroup waited
  // for in step kb - 1.
  auto ring_wait = [&]() {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
  };
  auto prefetch = [&](int kb) {
    if (kb + 1 < n_kb) load_kv(kb + 1);
  };
  // Queueing a step's wgmmas holds a warp until the tensor cores have taken
  // most of them, so the two warpgroups take turns: warpgroup 1 copies
  // first and queues its own only once warpgroup 0 has (named barrier 1,
  // one arrive and one sync per step), and warpgroup 0's softmax then runs
  // while the tensor cores work through warpgroup 1's products.
  auto turn_wait = [&]() {
    if (wg == 1) asm volatile("bar.sync 1, %0;\n" ::"n"(kTcThreads) : "memory");
  };
  auto turn_pass = [&]() {
    if (wg == 0) asm volatile("bar.arrive 1, %0;\n" ::"n"(kTcThreads) : "memory");
  };

  // It multiplies K tile kb while the P V product of step kb - 1 is
  // still in flight: it queues S = Q K_kb^T, then P_{kb-1} V_{kb-1}, waits
  // for S alone, and runs the softmax on the CUDA cores while the tensor
  // cores work through the P V product. WITH_PV is false at step 0 only;
  // every wgmma group and its wait lie on one path, so the compiler keeps the
  // groups asynchronous.
  uint32_t v_prev = 0;
  auto step = [&](int kb, auto with_pv) {
    constexpr bool kWithPV = decltype(with_pv)::value;
    ring_wait();
    if (wg == 1) prefetch(kb);
    turn_wait();
    const uint32_t k_st = kv_s + (kb % kStages) * 2 * kKVBytes;
    const int64_t c0 = static_cast<int64_t>(kb) * kTileKV;

    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSSteps; ++kk) {
      const uint32_t qa = q_s + (kk / 4) * (kTileQ * 128) + wg * (64 * 128) +
                          (kk % 4) * 32;
      const uint32_t ka = k_st + (kk / 4) * (kTileKV * 128) + (kk % 4) * 32;
      wgmma_ss_m64n64(s, kmajor_desc(qa), kmajor_desc(ka), kk > 0);
    }
    wgmma_commit();
    if constexpr (kWithPV) start_pv(v_prev);
    turn_pass();
    if (wg == 0) prefetch(kb);
    if constexpr (kWithPV) {
      wgmma_wait<1>();     // S has landed; P V may still run
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);

    // scale and mask; s[4 j + 2 h + e] is (row_a + 8 h, c0 + 8 j + col_t + e).
    // Row h keeps the tile's columns below lim[h]: those before kv_len
    // and, with causal, at or before row + row_offset.
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale;
    if (c0 + kTileKV > kv_len ||
        (causal && c0 + kTileKV - 1 > wg_row0 + row_offset)) {
      int lim[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int64_t c = kv_len - c0;
        if (causal && row_a + 8 * h + row_offset + 1 - c0 < c)
          c = row_a + 8 * h + row_offset + 1 - c0;
        lim[h] = static_cast<int>(c < 0 ? 0 : c < kTileKV ? c : kTileKV);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (8 * (i / 4) + col_t + (i % 2) >= lim[(i / 2) % 2]) s[i] = kNegInf;
    }

    // online softmax of the thread's two rows (four threads share a row)
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = expf(s[4 * j + 2 * h + e] - m_new);
          s[4 * j + 2 * h + e] = pv;
          rs += pv;
        }
      l[h] = alpha[h] * l[h] + rs;   // this thread's share of the row sum
    }

    if constexpr (kWithPV) {
      wgmma_wait<0>();     // P_{kb-1} V_{kb-1} is done with acc and pt
      fence_pv();
    }
#pragma unroll
    for (int i = 0; i < kNO; ++i) acc[i] *= alpha[(i / 2) % 2];

    // P as the A operand: register r of k16 step kk holds the pair
    // s[8 kk + 2 r], s[8 kk + 2 r + 1]; three bf16 terms of each
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], pt[0][kk][r],
               pt[1][kk][r], pt[2][kk][r]);
    v_prev = k_st + kKVBytes;
  };

  // The blocks this warpgroup multiplies: none when its rows lie past Sq;
  // with causal, none wholly above its diagonal (they add exactly 0). It
  // still takes its part in the ring for the rest of the block's steps.
  int n_live = wg_live ? n_kb : 0;
  if (causal && wg_live) {
    const int64_t last = (wg_row0 + 63 + row_offset) / kTileKV + 1;
    if (last < n_live) n_live = static_cast<int>(last);
  }
  int kb = 0;
  if (n_live > 0) {
    step(0, std::false_type{});
    for (kb = 1; kb < n_live; ++kb) step(kb, std::true_type{});
    start_pv(v_prev);
    wgmma_wait<0>();
    fence_pv();
  }
  for (; kb < n_kb; ++kb) {
    ring_wait();
    prefetch(kb);
    turn_wait();
    turn_pass();
  }

  // O / l, rounded once to bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int64_t row = row_a + 8 * h;
    if (!wg_live || row >= sq) continue;
    __nv_bfloat16* orow = o + (bh * sq + row) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + col_t + e;
        if (col < d) orow[col] = __float2bfloat16(acc[4 * j + 2 * h + e] / lt);
      }
  }
}

template <int DP>
cudaError_t launch_fa_bf16(const void* q, const void* k, const void* v,
                           void* o, int64_t bh, int64_t group, int64_t sq,
                           int64_t skv, int d, int64_t kv_len, int causal,
                           int64_t row_offset, float scale,
                           cudaStream_t stream) {
  // 1024 bytes of slack to align the tiles for the swizzle
  const size_t smem =
      kTileQ * DP * 2 + kStages * 2 * kTileKV * DP * 2 + 1024;
  auto kernel = flash_attention_bf16_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int vec = d % 8 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((sq + kTileQ - 1) / kTileQ));
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      group, sq, skv, kv_len, d, causal, row_offset, scale, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K6: O (BH, Sq, D) = attention of Q (BH, Sq, D) over K, V (BH / group,
// Skv, D); query head bh reads KV head bh / group. Columns at or past
// kv_len are masked, and with causal every col > row + row_offset. bf16 !=
// 0 means all four tensors are bf16 (the tensor-core body), else fp32 (the
// FMA body). scale_bits holds the fp32 scale's bits.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int64_t bh, int64_t group, int64_t sq, int64_t skv,
                    int64_t d, int64_t kv_len, int64_t causal, int64_t bf16,
                    int64_t scale_bits, int64_t row_offset, int64_t device,
                    void* stream) {
  if (d < 1 || d > kMaxD || bh < 1 || group < 1 || sq < 1 || kv_len < 1 ||
      kv_len > skv || row_offset < 0 || bh > INT32_MAX ||
      (sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const uint32_t bits = static_cast<uint32_t>(scale_bits);
  float scale;
  memcpy(&scale, &bits, sizeof scale);
  auto s = static_cast<cudaStream_t>(stream);
  const int di = static_cast<int>(d), c = causal != 0;
  cudaError_t err;
  if (bf16 != 0)
    err = d <= 64 ? launch_fa_bf16<64>(q, k, v, o, bh, group, sq, skv, di,
                                       kv_len, c, row_offset, scale, s)
                  : launch_fa_bf16<128>(q, k, v, o, bh, group, sq, skv, di,
                                        kv_len, c, row_offset, scale, s);
  else
    err = d <= 64 ? launch_fa_f32<1>(q, k, v, o, bh, group, sq, skv, di,
                                     kv_len, c, row_offset, scale, s)
                  : launch_fa_f32<2>(q, k, v, o, bh, group, sq, skv, di,
                                     kv_len, c, row_offset, scale, s);
  return static_cast<int>(err);
}

}  // extern "C"
