// K6 flash_attention: online-softmax attention, fp32 statistics.
//
// Replaces
//   K6  src/repro/kernels/flash_attention/kernel.py :: flash_attention_kernel
//       (body _fa_kernel): O (BH, Sq, D) = softmax(Q K^T * scale) V over
//       Q (BH, Sq, D) and K, V (BH, Skv, D), fp32 running max, sum and
//       accumulator, a causal mask aligned at the top left (row >= col),
//       a kv_len mask on padded columns, -1e30 as the masked value.
//
// Here K and V carry BH / group heads: query head bh reads KV head
// bh / group (GQA), so the repeated K/V of the reference's wrapper are never
// materialized. Inputs are fp32 or bf16, converted to fp32 on load; the
// output is written in the input type.
//
// What bounds it on an H100: at the LM prefill shape (BH 64, Sq 4096, Skv
// 4112, D 128) the useful work is 4 D operations per unmasked (row, col)
// pair, about 2.8e11, against 3.2e8 bytes of Q, K, V and O: about 850
// operations per byte, far above the ridge point, so attention is bound by
// operations (0.28 ms a layer at the bf16 tensor-core peak).
//
// Design (simple first; tensor cores and TMA are the next step): one block
// of 256 threads per (head, 64-row Q block). The Q block sits in shared
// memory as fp32 for the whole KV sweep; each 64-row K and V block is
// staged beside it. A thread owns 4 rows x 4 columns of the 64 x 64 score
// tile (rows ty + 16 i, columns tx + 16 j) and computes them with fp32 FMAs
// over float4 reads of Q and K rows; K rows are padded by 4 floats so a
// quarter warp reads 8 rows on distinct banks. The row max and sum reduce
// over the 16 threads of a row with shuffles and stay in registers, as does
// the thread's 4 x (64 or 128) slice of the output accumulator, rescaled by
// alpha = exp(m_prev - m_new) per block. P goes through shared memory (over
// the K tile, which is no longer needed) for the P V product. KV blocks that
// lie wholly above the causal diagonal are skipped: past block 0 they would
// add exactly 0, since column 0 is valid for every row. Q blocks run from
// the last (longest causal rows) to the first, to balance the tail.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // KV rows per step
constexpr int kThreads = 256;      // 16 x 16: tx along columns, ty along rows
constexpr int kLdp = kBK + 4;      // row stride of the P tile
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;  // the reference's masked value

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

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
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t row0, int64_t n_rows, int d,
                                          int dp, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const bool row_ok = row0 + r < n_rows;
    const T* s = src + (row0 + r) * d;
    for (int c = lane; c < dp; c += 32)
      dst[r * ld + c] = (row_ok && c < d) ? to_f32(s[c]) : 0.f;
  }
}

template <typename T, int NG>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int64_t group, int64_t sq, int64_t kv_len, int d,
                       int causal, float scale, int64_t skv) {
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
  const T* kp = k + (bh / group) * skv * d;
  const T* vp = v + (bh / group) * skv * d;

  load_tile(qs, q + bh * sq * d, q0, sq, d, dp, ld);

  int64_t kv_end = kv_len;
  if (causal) {
    const int64_t last_row = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
    if (last_row + 1 < kv_end) kv_end = last_row + 1;
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
        const bool ok = col < kv_len && (!causal || col <= row);
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
    T* orow = o + (bh * sq + row) * d;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * g + tx * 4 + e;
        if (col < d) orow[col] = from_f32<T>(acc[i][g][e] / l[i]);
      }
  }
}

template <typename T, int NG>
cudaError_t launch_fa(const void* q, const void* k, const void* v, void* o,
                      int64_t bh, int64_t group, int64_t sq, int64_t skv,
                      int d, int64_t kv_len, int causal, float scale,
                      cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kBQ * tile_ld(d) + k_region(d) + kBK * 64 * NG);
  auto kernel = flash_attention_kernel<T, NG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((sq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), group, sq, kv_len, d,
      causal, scale, skv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K6: O (BH, Sq, D) = attention of Q (BH, Sq, D) over K, V (BH / group,
// Skv, D); query head bh reads KV head bh / group. Columns at or past
// kv_len are masked, and with causal every col > row. bf16 != 0 means all
// four tensors are bf16, else fp32. scale_bits holds the fp32 scale's bits.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int64_t bh, int64_t group, int64_t sq, int64_t skv,
                    int64_t d, int64_t kv_len, int64_t causal, int64_t bf16,
                    int64_t scale_bits, int64_t device, void* stream) {
  if (d < 1 || d > kMaxD || bh < 1 || group < 1 || sq < 1 || kv_len < 1 ||
      kv_len > skv || bh > INT32_MAX || (sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(static_cast<int>(device));
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const uint32_t bits = static_cast<uint32_t>(scale_bits);
  float scale;
  memcpy(&scale, &bits, sizeof scale);
  auto s = static_cast<cudaStream_t>(stream);
  const int di = static_cast<int>(d), c = causal != 0;
  cudaError_t err;
  if (bf16 != 0)
    err = d <= 64 ? launch_fa<__nv_bfloat16, 1>(q, k, v, o, bh, group, sq,
                                               skv, di, kv_len, c, scale, s)
                  : launch_fa<__nv_bfloat16, 2>(q, k, v, o, bh, group, sq,
                                               skv, di, kv_len, c, scale, s);
  else
    err = d <= 64 ? launch_fa<float, 1>(q, k, v, o, bh, group, sq, skv, di,
                                        kv_len, c, scale, s)
                  : launch_fa<float, 2>(q, k, v, o, bh, group, sq, skv, di,
                                        kv_len, c, scale, s);
  return static_cast<int>(err);
}

}  // extern "C"
