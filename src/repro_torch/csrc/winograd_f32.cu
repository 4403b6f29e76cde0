// K3 wino_input_transform_f32 and K4 wino_output_transform_f32.
//
// Replaces
//   K3  src/repro/kernels/winograd/kernel.py :: input_transform_kernel
//       tiles (T, PT, PT, C) -> V = B^T d B laid out (PT^2, T, C)
//   K4  src/repro/kernels/winograd/kernel.py :: output_transform_kernel
//       M (PT^2, T, K) -> Y = A^T M A laid out (T, m, m, K), + bias, ReLU
//
// Both take NHWC geometry, so the Winograd PE runs x -> K3 -> K2 -> K4 -> y
// with no copy in between. K3 reads the tiles straight out of the image x
// (N, H, W, C): tile (n, th, tw) is the PT x PT window whose top left pixel
// is (th m - pad_top, tw m - pad_left); what falls outside x reads 0. That
// covers SAME, VALID, the executor's width-only pad and the pad that makes
// the tile grid (nh x nw) cover the output. K4 writes Y straight into
// (N, Ho, Wo, K), each output predicated by the crop th m + i < Ho,
// tw m + j < Wo. The reference's layouts are the special case N = T,
// H = W = PT (K3) or Ho = Wo = m (K4), nh = nw = 1, no pad. Tile t is
// (n nh + th) nw + tw.
//
// What bounds them on an H100: a few adds per value against a handful of
// constants, about 3 flops a byte against the fp32 ridge point of 20, so
// device-memory bytes, and for small layers the host's launch path.
//
// Design (the vector route, channels a multiple of 4, 16-byte aligned
// pointers): every access is a float4 along the channels.
// - K3: a block takes one strip of 32 output columns (32 / m tiles of one
//   tile row) by 64 channels. cp.async copies the strip's PT x 34 x 64
//   window into shared memory, zero-filling (source size 0) where the
//   window leaves the image, so each input byte leaves device memory once
//   per tile row and the 2-pixel overlap of neighbouring tiles is read from
//   shared memory. The column transform B^T d runs once per window column,
//   in place; then each thread takes one (tile, 4 channels) and writes its
//   PT^2 results, a warp 512 contiguous bytes of a V plane where C = 64.
// - K4: each thread takes one (tile, 4 channels of K), reads its 36 (or 16)
//   values one plane after the other, a warp 512 contiguous bytes of a plane
//   where K = 64, folds each column of M into the m x m sums as it arrives,
//   and writes m x m float4s into the NHWC rows with the bias and ReLU.
// The scalar route (any channel count or alignment) takes one thread per
// (tile, channel) and scalar loads, with the same geometry. The transform
// matrices are compile-time constants; zero coefficients are skipped.
// Offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

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

// The NHWC geometry of K3's input image or K4's output image, and the
// tile grid over it. pad_top and pad_left are K3's only.
struct Geom {
  int64_t n, h, w, c;
  int64_t pad_top, pad_left;
  int64_t nh, nw;
};

// s += k * d, skipping a zero coefficient (k is a constant once unrolled)
__device__ __forceinline__ void axpy(float4& s, float k, const float4& d) {
  if (k == 0.f) return;
  s.x += k * d.x;
  s.y += k * d.y;
  s.z += k * d.z;
  s.w += k * d.w;
}

__device__ __forceinline__ void axpy(float& s, float k, float d) {
  if (k != 0.f) s += k * d;
}

// K3's vector route: a strip of kStripCols output columns by kLanes float4
// lanes (4 kLanes channels) a block; the window adds the 2-pixel halo.
constexpr int kLanes = 16;
constexpr int kStripCols = 32;
constexpr int kWinCols = kStripCols + 2;

template <int M>
struct Strip {
  static constexpr int PT = M + 2;
  static constexpr int kTiles = kStripCols / M;
  static constexpr int kThreads = kTiles * kLanes;
  static constexpr int kSmem = PT * kWinCols * kLanes * 16;
};

template <int M>
__global__ void __launch_bounds__(Strip<M>::kThreads)
wino_input_vec_kernel(const float* __restrict__ x, float* __restrict__ v,
                      Geom g) {
  using S = Strip<M>;
  constexpr int PT = S::PT;
  constexpr int kRow = kWinCols * kLanes;   // float4s in a window row
  extern __shared__ float4 win[];           // [PT][kWinCols][kLanes]
  const int64_t strips = (g.nw + S::kTiles - 1) / S::kTiles;
  const int64_t row = blockIdx.x / strips;  // n nh + th
  const int64_t tw0 = (blockIdx.x % strips) * S::kTiles;
  const int64_t n = row / g.nh, th = row % g.nh;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * 4 * kLanes;
  const int64_t y0 = th * M - g.pad_top, x0 = tw0 * M - g.pad_left;
  const float* img = x + n * g.h * g.w * g.c;

  // stage the window; zero where it leaves the image or the channels
  for (int e = threadIdx.x; e < PT * kRow; e += S::kThreads) {
    const int l = e % kLanes, col = (e / kLanes) % kWinCols, p = e / kRow;
    const int64_t yy = y0 + p, xx = x0 + col, cc = c0 + 4 * l;
    const bool in = yy >= 0 && yy < g.h && xx >= 0 && xx < g.w && cc < g.c;
    const float* src = in ? img + (yy * g.w + xx) * g.c + cc : x;
    cp_async16(smem_addr(&win[e]), src, in ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // B^T d, once per window column, in place
  for (int e = threadIdx.x; e < kRow; e += S::kThreads) {
    float4 d[PT];
#pragma unroll
    for (int p = 0; p < PT; ++p) d[p] = win[p * kRow + e];
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int p = 0; p < PT; ++p) axpy(s, Wino<M>::bt(i, p), d[p]);
      win[i * kRow + e] = s;
    }
  }
  __syncthreads();

  // (B^T d) B for tile j of the strip, lanes l: V (PT^2, T, C)
  const int j = threadIdx.x / kLanes, l = threadIdx.x % kLanes;
  const int64_t tw = tw0 + j, cc = c0 + 4 * l;
  if (tw >= g.nw || cc >= g.c) return;
  const int64_t plane = g.n * g.nh * g.nw * g.c / 4;   // float4s a plane
  float4* dst = reinterpret_cast<float4*>(v + (row * g.nw + tw) * g.c + cc);
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    float4 r[PT];
#pragma unroll
    for (int q = 0; q < PT; ++q)
      r[q] = win[i * kRow + (j * M + q) * kLanes + l];
#pragma unroll
    for (int jj = 0; jj < PT; ++jj) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < PT; ++q) axpy(s, Wino<M>::bt(jj, q), r[q]);
      dst[(i * PT + jj) * plane] = s;
    }
  }
}

// Tile t's (n, th, tw)
__device__ __forceinline__ void tile_pos(const Geom& g, int64_t t, int64_t& n,
                                         int64_t& th, int64_t& tw) {
  tw = t % g.nw;
  const int64_t r = t / g.nw;
  th = r % g.nh;
  n = r / g.nh;
}

// K3's scalar route: one thread per (tile, channel)
template <int M>
__global__ void __launch_bounds__(256)
wino_input_scalar_kernel(const float* __restrict__ x, float* __restrict__ v,
                         Geom g) {
  constexpr int PT = Wino<M>::PT;
  const int64_t T = g.n * g.nh * g.nw;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= T * g.c) return;
  const int64_t t = idx / g.c, c = idx % g.c;
  int64_t n, th, tw;
  tile_pos(g, t, n, th, tw);
  const int64_t y0 = th * M - g.pad_top, x0 = tw * M - g.pad_left;
  const float* img = x + n * g.h * g.w * g.c + c;

  float d[PT][PT];
#pragma unroll
  for (int p = 0; p < PT; ++p)
#pragma unroll
    for (int q = 0; q < PT; ++q) {
      const int64_t yy = y0 + p, xx = x0 + q;
      d[p][q] = yy >= 0 && yy < g.h && xx >= 0 && xx < g.w
                    ? img[(yy * g.w + xx) * g.c]
                    : 0.f;
    }
  float tmp[PT][PT];   // B^T d
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int q = 0; q < PT; ++q) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < PT; ++p) axpy(s, Wino<M>::bt(i, p), d[p][q]);
      tmp[i][q] = s;
    }
  const int64_t plane = T * g.c;
  float* dst = v + t * g.c + c;
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < PT; ++q) axpy(s, Wino<M>::bt(j, q), tmp[i][q]);
      dst[(i * PT + j) * plane] = s;
    }
}

// K4's vector route: kOutTiles tiles by kLanes float4 lanes a block
constexpr int kOutTiles = 8;
constexpr int kOutThreads = kOutTiles * kLanes;

template <int M>
__global__ void __launch_bounds__(kOutThreads)
wino_output_vec_kernel(const float* __restrict__ mm,
                       const float* __restrict__ bias, float* __restrict__ y,
                       Geom g, int relu) {
  constexpr int PT = Wino<M>::PT;
  const int64_t T = g.n * g.nh * g.nw;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kOutTiles +
                    threadIdx.x / kLanes;
  const int64_t k = (static_cast<int64_t>(blockIdx.y) * kLanes +
                     threadIdx.x % kLanes) * 4;
  if (t >= T || k >= g.c) return;
  const int64_t plane = T * g.c / 4;   // float4s a plane
  const float4* src = reinterpret_cast<const float4*>(mm + t * g.c + k);

  float4 acc[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  // column q of M: (A^T M)[i][q], folded into Y[i][j] += (A^T M)[i][q] A[q][j]
#pragma unroll
  for (int q = 0; q < PT; ++q) {
    float4 col[PT];
#pragma unroll
    for (int p = 0; p < PT; ++p) col[p] = __ldg(src + (p * PT + q) * plane);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int p = 0; p < PT; ++p) axpy(s, Wino<M>::at(i, p), col[p]);
#pragma unroll
      for (int j = 0; j < M; ++j) axpy(acc[i][j], Wino<M>::at(j, q), s);
    }
  }
  const float4 b = bias != nullptr
                       ? __ldg(reinterpret_cast<const float4*>(bias + k))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t n, th, tw;
  tile_pos(g, t, n, th, tw);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int64_t oy = th * M + i;
    if (oy >= g.h) break;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int64_t ox = tw * M + j;
      if (ox >= g.w) break;
      float4 o = acc[i][j];
      o.x += b.x;
      o.y += b.y;
      o.z += b.z;
      o.w += b.w;
      if (relu) {
        o.x = fmaxf(o.x, 0.f);
        o.y = fmaxf(o.y, 0.f);
        o.z = fmaxf(o.z, 0.f);
        o.w = fmaxf(o.w, 0.f);
      }
      *reinterpret_cast<float4*>(y + ((n * g.h + oy) * g.w + ox) * g.c + k) =
          o;
    }
  }
}

// K4's scalar route: one thread per (tile, channel of K)
template <int M>
__global__ void __launch_bounds__(256)
wino_output_scalar_kernel(const float* __restrict__ mm,
                          const float* __restrict__ bias,
                          float* __restrict__ y, Geom g, int relu) {
  constexpr int PT = Wino<M>::PT;
  const int64_t T = g.n * g.nh * g.nw;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= T * g.c) return;
  const int64_t t = idx / g.c, k = idx % g.c;
  const int64_t plane = T * g.c;
  const float* src = mm + t * g.c + k;

  float d[PT][PT];
#pragma unroll
  for (int p = 0; p < PT; ++p)
#pragma unroll
    for (int q = 0; q < PT; ++q) d[p][q] = src[(p * PT + q) * plane];
  float tmp[M][PT];   // A^T M
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int q = 0; q < PT; ++q) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < PT; ++p) axpy(s, Wino<M>::at(i, p), d[p][q]);
      tmp[i][q] = s;
    }
  const float b = bias != nullptr ? bias[k] : 0.f;
  int64_t n, th, tw;
  tile_pos(g, t, n, th, tw);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int64_t oy = th * M + i;
    if (oy >= g.h) break;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int64_t ox = tw * M + j;
      if (ox >= g.w) break;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < PT; ++q) axpy(s, Wino<M>::at(j, q), tmp[i][q]);
      s += b;
      if (relu && s < 0.f) s = 0.f;
      y[((n * g.h + oy) * g.w + ox) * g.c + k] = s;
    }
  }
}

constexpr int kScalarThreads = 256;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the vector route takes channels in fours and 16-byte aligned pointers
bool takes_vec(const void* a, const void* b, const void* c, int64_t channels) {
  return channels % 4 == 0 && aligned16(a) && aligned16(b) &&
         (c == nullptr || aligned16(c));
}

bool geom_ok(const Geom& g, int64_t m) {
  if (g.n < 1 || g.h < 1 || g.w < 1 || g.c < 1 || g.nh < 1 || g.nw < 1)
    return false;
  if (m != 2 && m != 4) return false;
  const int64_t items = g.n * g.nh * g.nw * g.c;
  return (items + kScalarThreads - 1) / kScalarThreads <= INT32_MAX;
}

dim3 scalar_grid(const Geom& g) {
  const int64_t items = g.n * g.nh * g.nw * g.c;
  return dim3(static_cast<unsigned>((items + kScalarThreads - 1) /
                                    kScalarThreads));
}

// K3's window above 48 KB of shared memory, once per device (the
// caller's, made current by the entry point's DeviceScope) and m
template <int M>
cudaError_t allow_input_smem() {
  static bool set[64] = {false};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device >= 0 && device < 64;
  if (cached && set[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(wino_input_vec_kernel<M>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Strip<M>::kSmem);
  if (err == cudaSuccess && cached) set[device] = true;
  return err;
}

template <int M>
cudaError_t launch_input(const float* x, float* v, const Geom& g,
                         cudaStream_t s) {
  if (!takes_vec(x, v, nullptr, g.c)) {
    wino_input_scalar_kernel<M><<<scalar_grid(g), kScalarThreads, 0, s>>>(
        x, v, g);
    return cudaGetLastError();
  }
  using S = Strip<M>;
  const int64_t blocks = g.n * g.nh * ((g.nw + S::kTiles - 1) / S::kTiles);
  const int64_t chunks = (g.c + 4 * kLanes - 1) / (4 * kLanes);
  if (blocks > INT32_MAX || chunks > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = allow_input_smem<M>();
  if (err != cudaSuccess) return err;
  wino_input_vec_kernel<M>
      <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(chunks)),
         S::kThreads, S::kSmem, s>>>(x, v, g);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_output(const float* mm, const float* bias, float* y,
                          const Geom& g, int relu, cudaStream_t s) {
  if (!takes_vec(mm, y, bias, g.c)) {
    wino_output_scalar_kernel<M><<<scalar_grid(g), kScalarThreads, 0, s>>>(
        mm, bias, y, g, relu);
    return cudaGetLastError();
  }
  const int64_t blocks = (g.n * g.nh * g.nw + kOutTiles - 1) / kOutTiles;
  const int64_t chunks = (g.c + 4 * kLanes - 1) / (4 * kLanes);
  if (blocks > INT32_MAX || chunks > 65535) return cudaErrorInvalidValue;
  wino_output_vec_kernel<M>
      <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(chunks)),
         kOutThreads, 0, s>>>(mm, bias, y, g, relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3: x (N, H, W, C) -> V (PT^2, N nh nw, C), PT = m + 2: tile (n, th, tw)
// is x's PT x PT window at (th m - pad_top, tw m - pad_left), 0 outside x.
// The reference's tiles (T, PT, PT, C) are N = T, H = W = PT, no pad,
// nh = nw = 1.
int wino_input_transform_f32(const float* x, float* v, int64_t n, int64_t h,
                             int64_t w, int64_t c, int64_t pad_top,
                             int64_t pad_left, int64_t nh, int64_t nw,
                             int64_t m, int64_t device, void* stream) {
  const Geom g{n, h, w, c, pad_top, pad_left, nh, nw};
  if (!geom_ok(g, m)) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(m == 4 ? launch_input<4>(x, v, g, s)
                                 : launch_input<2>(x, v, g, s));
}

// K4: M (PT^2, N nh nw, K) -> Y (N, Ho, Wo, K) = A^T M A + bias (K)
// [ReLU], tile (n, th, tw)'s m x m outputs at (th m, tw m), cropped to
// Ho x Wo. bias may be null. The reference's (T, m, m, K) is N = T,
// Ho = Wo = m, nh = nw = 1.
int wino_output_transform_f32(const float* mm, const float* bias, float* y,
                              int64_t n, int64_t ho, int64_t wo, int64_t k,
                              int64_t nh, int64_t nw, int64_t m, int64_t relu,
                              int64_t device, void* stream) {
  const Geom g{n, ho, wo, k, 0, 0, nh, nw};
  if (!geom_ok(g, m)) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  auto s = static_cast<cudaStream_t>(stream);
  const int r = relu != 0;
  return static_cast<int>(m == 4 ? launch_output<4>(mm, bias, y, g, r, s)
                                 : launch_output<2>(mm, bias, y, g, r, s));
}

// The route K3 (x, V) or K4 (M, Y, bias) takes for these operands: 1 the
// float4 body, 0 the scalar one. `channels` is C for K3, K for K4.
int wino_f32_route(const void* a, const void* b, const void* c,
                   int64_t channels) {
  return takes_vec(a, b, c, channels) ? 1 : 0;
}

}  // extern "C"
