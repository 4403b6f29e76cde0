// K3 wino_input_transform_f32 and K4 wino_output_transform_f32.
//
// Replaces
//   K3  src/repro/kernels/winograd/kernel.py :: input_transform_kernel
//       tiles (T, PT, PT, C) -> V = B^T d B laid out (PT^2, T, C)
//   K4  src/repro/kernels/winograd/kernel.py :: output_transform_kernel
//       M (PT^2, T, K) -> Y = A^T M A laid out (T, m, m, K), + bias, ReLU
//
// What bounds it on an H100: each output element costs a few adds of a
// PT-long row of constants against every input element it reads once, far
// below the ridge point, so both kernels are bound by device-memory bytes
// (conv1 at batch 8: about 231 MB in and 231 MB out for K3).
//
// Design: one thread per (tile, channel). The thread gathers its PT x PT
// values (stride C apart, so a warp reads 32 consecutive channels of the
// same tile position: coalesced), applies the two small transforms in
// registers with the matrices as compile-time constants (the compiler folds
// the zeros and the unit coefficients away), and writes its PT^2 (K3) or
// m^2 (K4) results, again coalesced along the channel. Every input byte is
// read once and every output byte written once, which is the bound. The
// transform is templated on m in {2, 4}; offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int M>
struct Wino;

template <>
struct Wino<2> {
  static constexpr int PT = 4;
  __device__ static __forceinline__ float bt(int i, int j) {
    const float v[4][4] = {{1.f, 0.f, -1.f, 0.f},
                           {0.f, 1.f, 1.f, 0.f},
                           {0.f, -1.f, 1.f, 0.f},
                           {0.f, 1.f, 0.f, -1.f}};
    return v[i][j];
  }
  __device__ static __forceinline__ float at(int i, int j) {
    const float v[2][4] = {{1.f, 1.f, 1.f, 0.f}, {0.f, 1.f, -1.f, -1.f}};
    return v[i][j];
  }
};

template <>
struct Wino<4> {
  static constexpr int PT = 6;
  __device__ static __forceinline__ float bt(int i, int j) {
    const float v[6][6] = {{4.f, 0.f, -5.f, 0.f, 1.f, 0.f},
                           {0.f, -4.f, -4.f, 1.f, 1.f, 0.f},
                           {0.f, 4.f, -4.f, -1.f, 1.f, 0.f},
                           {0.f, -2.f, -1.f, 2.f, 1.f, 0.f},
                           {0.f, 2.f, -1.f, -2.f, 1.f, 0.f},
                           {0.f, 4.f, 0.f, -5.f, 0.f, 1.f}};
    return v[i][j];
  }
  __device__ static __forceinline__ float at(int i, int j) {
    const float v[4][6] = {{1.f, 1.f, 1.f, 1.f, 1.f, 0.f},
                           {0.f, 1.f, -1.f, 2.f, -2.f, 0.f},
                           {0.f, 1.f, 1.f, 4.f, 4.f, 0.f},
                           {0.f, 1.f, -1.f, 8.f, -8.f, 1.f}};
    return v[i][j];
  }
};

template <int M>
__global__ void __launch_bounds__(256)
wino_input_kernel(const float* __restrict__ tiles, float* __restrict__ v,
                  int64_t T, int64_t C) {
  constexpr int PT = Wino<M>::PT;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= T * C) return;
  const int64_t t = idx / C, c = idx % C;
  const float* src = tiles + t * (PT * PT) * C + c;

  float d[PT][PT];
#pragma unroll
  for (int p = 0; p < PT; ++p)
#pragma unroll
    for (int q = 0; q < PT; ++q) d[p][q] = src[(p * PT + q) * C];

  // tmp = B^T d
  float tmp[PT][PT];
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int q = 0; q < PT; ++q) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < PT; ++p) s += Wino<M>::bt(i, p) * d[p][q];
      tmp[i][q] = s;
    }
  // V = tmp B, written to (PT^2, T, C)
  const int64_t plane = T * C;
  float* dst = v + t * C + c;
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < PT; ++q) s += tmp[i][q] * Wino<M>::bt(j, q);
      dst[(i * PT + j) * plane] = s;
    }
}

template <int M>
__global__ void __launch_bounds__(256)
wino_output_kernel(const float* __restrict__ mm, const float* __restrict__ bias,
                   float* __restrict__ y, int64_t T, int64_t K, int relu) {
  constexpr int PT = Wino<M>::PT;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= T * K) return;
  const int64_t t = idx / K, k = idx % K;
  const int64_t plane = T * K;
  const float* src = mm + t * K + k;

  float d[PT][PT];
#pragma unroll
  for (int p = 0; p < PT; ++p)
#pragma unroll
    for (int q = 0; q < PT; ++q) d[p][q] = src[(p * PT + q) * plane];

  // tmp = A^T M  (m x PT)
  float tmp[M][PT];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int q = 0; q < PT; ++q) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < PT; ++p) s += Wino<M>::at(i, p) * d[p][q];
      tmp[i][q] = s;
    }
  const float b = bias != nullptr ? bias[k] : 0.f;
  float* dst = y + t * (M * M) * K + k;
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < PT; ++q) s += tmp[i][q] * Wino<M>::at(j, q);
      s += b;
      if (relu && s < 0.f) s = 0.f;
      dst[(i * M + j) * K] = s;
    }
}

constexpr int kThreads = 256;

dim3 grid_for(int64_t n) {
  return dim3(static_cast<unsigned>((n + kThreads - 1) / kThreads));
}

bool grid_ok(int64_t n) {
  return n > 0 && (n + kThreads - 1) / kThreads <= INT32_MAX;
}

}  // namespace

extern "C" {

// K3: tiles (T, PT, PT, C) -> V (PT^2, T, C), PT = m + 2.
int wino_input_transform_f32(const float* tiles, float* v, int64_t t,
                             int64_t c, int64_t m, int64_t device,
                             void* stream) {
  if (!grid_ok(t * c)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(static_cast<int>(device));
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  auto s = static_cast<cudaStream_t>(stream);
  if (m == 4)
    wino_input_kernel<4><<<grid_for(t * c), kThreads, 0, s>>>(tiles, v, t, c);
  else if (m == 2)
    wino_input_kernel<2><<<grid_for(t * c), kThreads, 0, s>>>(tiles, v, t, c);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K4: M (PT^2, T, K) -> Y (T, m, m, K) = A^T M A + bias (K) [ReLU].
// bias may be null.
int wino_output_transform_f32(const float* mm, const float* bias, float* y,
                              int64_t t, int64_t k, int64_t m, int64_t relu,
                              int64_t device, void* stream) {
  if (!grid_ok(t * k)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(static_cast<int>(device));
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  auto s = static_cast<cudaStream_t>(stream);
  const int r = relu != 0;
  if (m == 4)
    wino_output_kernel<4><<<grid_for(t * k), kThreads, 0, s>>>(mm, bias, y, t,
                                                              k, r);
  else if (m == 2)
    wino_output_kernel<2><<<grid_for(t * k), kThreads, 0, s>>>(mm, bias, y, t,
                                                              k, r);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
