// The ASA exchange's kernels for Hopper (sm_90a): the full-precision chunk
// sum, the fp16 wire casts and the blockwise int8 quantizers. Plain C
// interface, loaded with ctypes (repro_torch/kernels/chunk_sum.py,
// quantize.py); each entry point launches on the caller's stream and
// returns cudaGetLastError().
//
// Replaces (JAX package, Pallas/TPU):
//   chunk_sum    src/repro/kernels/chunk_sum.py:_chunk_sum_kernel
//   quant_fp16   src/repro/kernels/quantize.py:_cast_kernel (to float16)
//   dequant_fp16 src/repro/kernels/quantize.py:_cast_kernel (to float32)
//   quant_int8   src/repro/kernels/quantize.py:_quant_int8_kernel
//   dequant_int8 src/repro/kernels/quantize.py:_dequant_int8_kernel
//
// chunk_sum: (k, n) receives of float32 / bfloat16 / float16 -> (n,) fp32,
// summed in row order 0..k-1 with one rounding per add (__fadd_rn, never
// contracted), so it equals the plain version's row-by-row sum bit for bit.
// The casts round as x.half() / h.float() do: __float2half_rn sends
// overflow to +-inf, keeps NaN and rounds subnormals to nearest even.
//
// What bounds them on an H100: bytes. Each reads its input once and writes
// its output once with one add or convert per element, far below the
// card's ~295 flops per byte. So the design is only to keep many wide loads
// in flight: a grid-stride loop in which each thread owns VEC consecutive
// elements, read and written as 16-byte (or 8-byte for 16-bit types)
// vectors where the address allows, scalars where it does not
// (quant_fp16: 8 values a thread and step, see quant_fp16_kernel). A (k, n)
// receive with n = ceil(total / k) not a multiple of VEC has rows that
// start off the vector grid (the trap of fp16 rows of odd length), so the
// alignment is tested per row; every thread of a warp sees the same row, so
// the test does not diverge.
//
// quant_int8: one thread block per block of block_n values (at most
// THREADS * MAX_PER). Each thread holds its values in registers, the block
// max of |x| is reduced with warp shuffles and one shared-memory stage, and
// then each value is written as rint(x / scale) clamped to +-127, with
// scale = fma(absmax, fp32(1/127), 1e-12): a true IEEE division and
// rounding half to even, as the plain version's torch.round(x / scale)
// and the Pallas kernel's jnp.round do, so all three agree bit for bit.
// Values past n count as zeros toward the last block's absmax and are not
// written.
// dequant_int8: a grid-stride loop over value blocks; each thread reads its
// block's scale once and writes q * scale for its values.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;            // elements a thread owns per iteration
constexpr int MAX_BLOCKS = 132 * 16;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }

// VEC elements from p (element offset already applied): one vector load
// when `aligned`, else VEC scalar loads.
template <typename T>
__device__ __forceinline__ void load4(const T* p, bool aligned, float out[VEC]) {
  if (aligned) {
    if constexpr (sizeof(T) == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      const T* h = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] = to_f<T>(h[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f<T>(p[i]);
  }
}

__device__ __forceinline__ bool aligned_to(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

inline int grid_for(long long items) {
  long long b = (items + THREADS - 1) / THREADS;
  if (b < 1) b = 1;
  return static_cast<int>(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

template <typename T>
__global__ void chunk_sum_kernel(const T* __restrict__ x, float* __restrict__ out, int k,
                                 long long n) {
  const long long groups = n / VEC;
  const bool out_al = aligned_to(out, 16);
  for (long long gi = blockIdx.x * (long long)blockDim.x + threadIdx.x; gi < groups;
       gi += (long long)gridDim.x * blockDim.x) {
    const long long j = gi * VEC;
    float acc[VEC], v[VEC];
    load4<T>(x + j, aligned_to(x + j, VEC * sizeof(T)), acc);
    for (int r = 1; r < k; ++r) {
      const T* row = x + (long long)r * n + j;
      load4<T>(row, aligned_to(row, VEC * sizeof(T)), v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], v[i]);
    }
    if (out_al) {
      *reinterpret_cast<float4*>(out + j) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[j + i] = acc[i];
    }
  }
  // the n % VEC tail, one element a thread of block 0
  const long long tail = groups * VEC;
  if (blockIdx.x == 0 && tail + threadIdx.x < n) {
    const long long j = tail + threadIdx.x;
    float acc = to_f<T>(x[j]);
    for (int r = 1; r < k; ++r) acc = __fadd_rn(acc, to_f<T>(x[(long long)r * n + j]));
    out[j] = acc;
  }
}

// quant_fp16 has a shape of its own (the one cast that trailed its PyTorch
// call on the shared one above): each thread converts CAST_VEC = 8 values a
// step, two 16-byte loads and one 16-byte store, and issues the loads of
// CAST_UNROLL = 2 steps (THREADS apart) before it converts either: 64 bytes
// in flight a thread. The grid covers the array in one pass (at the f6.w
// bucket 9216 blocks, some 70 waves of 8 blocks on each of 132 SMs): on an
// H100 a grid of one wave walking the array in a stride loop was slower,
// and 4 or 8 steps in flight, warp-coalesced 8-byte stores, streaming
// cache hints or L2 prefetch hints were no faster.
constexpr int CAST_VEC = 8;
constexpr int CAST_UNROLL = 2;

inline int cast_grid(long long groups) {
  const long long per = (long long)THREADS * CAST_UNROLL;
  const long long b = (groups + per - 1) / per;
  return static_cast<int>(b < 1 ? 1 : b);
}

__global__ void __launch_bounds__(THREADS)
quant_fp16_kernel(const float* __restrict__ x, __half* __restrict__ out, long long n) {
  const long long groups = n / CAST_VEC;
  const bool al = aligned_to(x, 16) && aligned_to(out, 16);
  const long long g0 = blockIdx.x * (long long)THREADS * CAST_UNROLL + threadIdx.x;
  float v[CAST_UNROLL][CAST_VEC];
#pragma unroll
  for (int u = 0; u < CAST_UNROLL; ++u) {
    const long long g = g0 + u * THREADS;
    if (g >= groups) break;
    const float* src = x + g * CAST_VEC;
    if (al) {
      const float4 a = reinterpret_cast<const float4*>(src)[0];
      const float4 b = reinterpret_cast<const float4*>(src)[1];
      v[u][0] = a.x; v[u][1] = a.y; v[u][2] = a.z; v[u][3] = a.w;
      v[u][4] = b.x; v[u][5] = b.y; v[u][6] = b.z; v[u][7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < CAST_VEC; ++i) v[u][i] = src[i];
    }
  }
#pragma unroll
  for (int u = 0; u < CAST_UNROLL; ++u) {
    const long long g = g0 + u * THREADS;
    if (g >= groups) break;
    union {
      uint4 u4;
      __half h[CAST_VEC];
    } w;
#pragma unroll
    for (int i = 0; i < CAST_VEC; ++i) w.h[i] = __float2half_rn(v[u][i]);
    __half* dst = out + g * CAST_VEC;
    if (al) {
      *reinterpret_cast<uint4*>(dst) = w.u4;
    } else {
#pragma unroll
      for (int i = 0; i < CAST_VEC; ++i) dst[i] = w.h[i];
    }
  }
  const long long tail = groups * CAST_VEC;   // the n % 8 tail, block 0
  if (blockIdx.x == 0 && tail + threadIdx.x < n)
    out[tail + threadIdx.x] = __float2half_rn(x[tail + threadIdx.x]);
}

__global__ void dequant_fp16_kernel(const __half* __restrict__ x, float* __restrict__ out,
                                    long long n) {
  const long long groups = n / VEC;
  const bool al = aligned_to(x, 8) && aligned_to(out, 16);
  for (long long gi = blockIdx.x * (long long)blockDim.x + threadIdx.x; gi < groups;
       gi += (long long)gridDim.x * blockDim.x) {
    const long long j = gi * VEC;
    float v[VEC];
    load4<__half>(x + j, al, v);
    if (al) {
      *reinterpret_cast<float4*>(out + j) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[j + i] = v[i];
    }
  }
  const long long tail = groups * VEC;
  if (blockIdx.x == 0 && tail + threadIdx.x < n)
    out[tail + threadIdx.x] = __half2float(x[tail + threadIdx.x]);
}

constexpr int MAX_PER = 16;       // values a thread holds: block_n <= 4096

__global__ void quant_int8_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                                  float* __restrict__ scales, long long n, int block_n) {
  __shared__ float warp_max[THREADS / 32];
  const long long base = (long long)blockIdx.x * block_n;
  float v[MAX_PER];
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < MAX_PER; ++j) {
    const int i = j * THREADS + threadIdx.x;
    v[j] = (i < block_n && base + i < n) ? x[base + i] : 0.0f;
    m = fmaxf(m, fabsf(v[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, warp_max[w]);
  // XLA compiles the JAX kernel's absmax / 127 + 1e-12 into one fma by
  // the fp32 reciprocal of 127; so does this line
  const float scale = __fmaf_rn(m, 1.0f / 127.0f, 1e-12f);
#pragma unroll
  for (int j = 0; j < MAX_PER; ++j) {
    const int i = j * THREADS + threadIdx.x;
    if (i < block_n && base + i < n) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(v[j], scale)), -127.0f), 127.0f);
      q[base + i] = static_cast<int8_t>(static_cast<int>(r));
    }
  }
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
}

__global__ void dequant_int8_kernel(const int8_t* __restrict__ q,
                                    const float* __restrict__ scales, float* __restrict__ out,
                                    long long n, int block_n, long long n_blocks) {
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const float s = scales[b];
    const long long base = b * block_n;
    const long long end = base + block_n < n ? base + block_n : n;
    for (long long i = base + threadIdx.x; i < end; i += THREADS)
      out[i] = __fmul_rn(static_cast<float>(q[i]), s);
  }
}

template <typename T>
int launch_chunk_sum(const void* x, void* out, int k, long long n, cudaStream_t s) {
  chunk_sum_kernel<T><<<grid_for(n / VEC), THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<float*>(out), k, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (k, n) row-major in dtype (0 float32, 1 bfloat16, 2 float16) -> out (n,) fp32.
int chunk_sum(const void* x, void* out, int k, long long n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 0 || n <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch_chunk_sum<float>(x, out, k, n, s);
    case 1: return launch_chunk_sum<__nv_bfloat16>(x, out, k, n, s);
    case 2: return launch_chunk_sum<__half>(x, out, k, n, s);
    default: return cudaErrorInvalidValue;
  }
}

// x (n,) fp32 -> out (n,) fp16
int quant_fp16(const void* x, void* out, long long n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  quant_fp16_kernel<<<cast_grid(n / CAST_VEC), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<__half*>(out), n);
  return cudaGetLastError();
}

// x (n,) fp16 -> out (n,) fp32
int dequant_fp16(const void* x, void* out, long long n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  dequant_fp16_kernel<<<grid_for(n / VEC), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __half*>(x), static_cast<float*>(out), n);
  return cudaGetLastError();
}

// x (n,) fp32 -> q (n,) int8 and scales (ceil(n / block_n),) fp32;
// 0 < block_n <= 4096.
int quant_int8(const void* x, void* q, void* scales, long long n, int block_n, void* stream) {
  if (n <= 0 || block_n <= 0 || block_n > THREADS * MAX_PER) return cudaErrorInvalidValue;
  const long long nb = (n + block_n - 1) / block_n;
  if (nb > 0x7fffffffLL) return cudaErrorInvalidValue;
  quant_int8_kernel<<<static_cast<unsigned>(nb), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(scales), n,
      block_n);
  return cudaGetLastError();
}

// q (n,) int8 and scales (ceil(n / block_n),) fp32 -> out (n,) fp32
int dequant_int8(const void* q, const void* scales, void* out, long long n, int block_n,
                 void* stream) {
  if (n <= 0 || block_n <= 0) return cudaErrorInvalidValue;
  const long long nb = (n + block_n - 1) / block_n;
  dequant_int8_kernel<<<grid_for(nb * THREADS), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), n, block_n, nb);
  return cudaGetLastError();
}

}  // extern "C"
