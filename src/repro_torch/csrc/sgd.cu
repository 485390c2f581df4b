// The momentum-SGD update kernels for Hopper (sm_90a): the flat fused
// update and the fused reduce-scatter tail (dequant + fp32 chunk sum +
// weight decay + momentum step on this rank's shard). Plain C interface,
// loaded with ctypes (repro_torch/kernels/fused_sgd.py,
// fused_rs_update.py); each entry point launches on the caller's stream and
// returns cudaGetLastError().
//
// Replaces (JAX package, Pallas/TPU):
//   fused_sgd        src/repro/kernels/fused_sgd.py:_fused_sgd_kernel
//   fused_rs_update  src/repro/kernels/fused_rs_update.py:_kernel (float
//                    wire) and _kernel_q (int8 wire, one fp32 scale per
//                    received chunk)
//
//   g  = scale * sum_r dequant(recv[r])          (fused_rs_update only)
//   g += weight_decay * mask * p                 (when a mask is given)
//   m' = momentum * m + g
//   p' = p - lr * (g + momentum * m')            (nesterov)
//      = p - lr * m'                             (classic)
//
// lr is read from a one-element fp32 device tensor, as the Pallas kernel
// reads lr_ref[0], so a captured step needs no new launch when lr changes.
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn/
// __fsub_rn are never contracted into an FMA), in the order the plain
// PyTorch versions compute them: so the kernels equal their plain versions
// bit for bit, and the fused kernel equals chunk_sum followed by
// fused_sgd bit for bit, since both share one tail (sgd_tail below).
//
// What bounds them on an H100: bytes. fused_sgd moves 5 fp32 words per
// element (p, g, m in; p', m' out) for ~5 flops; fused_rs_update moves k
// wire words + 3 (p, m, mask) in and 2 out. The design keeps wide loads in
// flight: a grid-stride loop, 4 consecutive elements a thread, 16-byte
// vectors for the fp32 operands where every pointer allows it (else
// scalars), and for the (k, s) receive a per-row alignment test, since
// s = ceil(total / k) is rarely a multiple of 4 and rows then start off the
// vector grid. The row test is the same for every thread of a warp.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;
constexpr int MAX_BLOCKS = 132 * 16;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ bool aligned_to(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// VEC elements from p: one vector load of VEC * sizeof(T) bytes when
// `aligned`, else VEC scalar loads.
template <typename T>
__device__ __forceinline__ void load4(const T* p, bool aligned, float out[VEC]) {
  if (aligned) {
    if constexpr (sizeof(T) == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else if constexpr (sizeof(T) == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      const T* h = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] = to_f<T>(h[i]);
    } else {
      const char4 v = *reinterpret_cast<const char4*>(p);
      out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f<T>(p[i]);
  }
}

inline int grid_for(long long items) {
  long long b = (items + THREADS - 1) / THREADS;
  if (b < 1) b = 1;
  return static_cast<int>(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

// The shared update tail on one element.
__device__ __forceinline__ void sgd_tail(float p, float g, float m, float lr, float momentum,
                                         bool nesterov, float& po, float& mo) {
  const float m_new = __fadd_rn(__fmul_rn(momentum, m), g);
  const float step = nesterov ? __fadd_rn(g, __fmul_rn(momentum, m_new)) : m_new;
  po = __fsub_rn(p, __fmul_rn(lr, step));
  mo = m_new;
}

struct Flat {   // the fp32 shard operands of one update
  const float* p;
  const float* m;
  const float* mask;   // nullptr: no weight decay
  float* po;
  float* mo;
  bool vec;            // every pointer 16-byte aligned
};

__device__ __forceinline__ void store4(float* p, bool vec, const float v[VEC]) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

// g (VEC summed gradients at element j) -> decay + momentum step, stored.
__device__ __forceinline__ void update4(const Flat& f, long long j, float g[VEC], float lr,
                                        float weight_decay, float momentum, bool nesterov) {
  float p[VEC], m[VEC], po[VEC], mo[VEC];
  load4<float>(f.p + j, f.vec, p);
  load4<float>(f.m + j, f.vec, m);
  if (f.mask != nullptr) {
    float mk[VEC];
    load4<float>(f.mask + j, f.vec, mk);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      g[i] = __fadd_rn(g[i], __fmul_rn(__fmul_rn(weight_decay, mk[i]), p[i]));
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) sgd_tail(p[i], g[i], m[i], lr, momentum, nesterov, po[i], mo[i]);
  store4(f.po + j, f.vec, po);
  store4(f.mo + j, f.vec, mo);
}

__device__ __forceinline__ void update1(const Flat& f, long long j, float g, float lr,
                                        float weight_decay, float momentum, bool nesterov) {
  const float p = f.p[j];
  if (f.mask != nullptr) g = __fadd_rn(g, __fmul_rn(__fmul_rn(weight_decay, f.mask[j]), p));
  sgd_tail(p, g, f.m[j], lr, momentum, nesterov, f.po[j], f.mo[j]);
}

__global__ void fused_sgd_kernel(const float* __restrict__ g, const float* __restrict__ lr_ptr,
                                 Flat f, long long n, float momentum, bool nesterov) {
  const float lr = *lr_ptr;
  const long long groups = n / VEC;
  for (long long gi = blockIdx.x * (long long)blockDim.x + threadIdx.x; gi < groups;
       gi += (long long)gridDim.x * blockDim.x) {
    const long long j = gi * VEC;
    float gv[VEC];
    load4<float>(g + j, f.vec, gv);
    update4(f, j, gv, lr, 0.f, momentum, nesterov);
  }
  const long long tail = groups * VEC;
  if (blockIdx.x == 0 && tail + threadIdx.x < n)
    update1(f, tail + threadIdx.x, g[tail + threadIdx.x], lr, 0.f, momentum, nesterov);
}

// recv (k, n) in T; scales (k,) fp32 or nullptr (float wire).
template <typename T>
__global__ void fused_rs_update_kernel(const T* __restrict__ recv, const float* __restrict__ scales,
                                       const float* __restrict__ lr_ptr, Flat f, int k, long long n,
                                       float scale, float weight_decay, float momentum,
                                       bool nesterov) {
  const float lr = *lr_ptr;
  const long long groups = n / VEC;
  for (long long gi = blockIdx.x * (long long)blockDim.x + threadIdx.x; gi < groups;
       gi += (long long)gridDim.x * blockDim.x) {
    const long long j = gi * VEC;
    float acc[VEC], v[VEC];
    for (int r = 0; r < k; ++r) {
      const T* row = recv + (long long)r * n + j;
      load4<T>(row, aligned_to(row, VEC * sizeof(T)), v);
      if (scales != nullptr) {
        const float sr = scales[r];
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = __fmul_rn(v[i], sr);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = r == 0 ? v[i] : __fadd_rn(acc[i], v[i]);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = __fmul_rn(acc[i], scale);
    update4(f, j, acc, lr, weight_decay, momentum, nesterov);
  }
  const long long tail = groups * VEC;
  if (blockIdx.x == 0 && tail + threadIdx.x < n) {
    const long long j = tail + threadIdx.x;
    float acc = 0.f;
    for (int r = 0; r < k; ++r) {
      float v = to_f<T>(recv[(long long)r * n + j]);
      if (scales != nullptr) v = __fmul_rn(v, scales[r]);
      acc = r == 0 ? v : __fadd_rn(acc, v);
    }
    update1(f, j, __fmul_rn(acc, scale), lr, weight_decay, momentum, nesterov);
  }
}

Flat make_flat(const void* p, const void* m, const void* mask, void* po, void* mo,
               const void* extra) {
  Flat f{static_cast<const float*>(p), static_cast<const float*>(m),
         static_cast<const float*>(mask), static_cast<float*>(po), static_cast<float*>(mo), false};
  auto al = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; };
  f.vec = al(p) && al(m) && al(po) && al(mo) && (mask == nullptr || al(mask)) &&
          (extra == nullptr || al(extra));
  return f;
}

template <typename T>
int launch_rs(const void* recv, const void* scales, const void* lr, Flat f, int k, long long n,
              float scale, float wd, float momentum, bool nesterov, cudaStream_t s) {
  fused_rs_update_kernel<T><<<grid_for(n / VEC), THREADS, 0, s>>>(
      static_cast<const T*>(recv), static_cast<const float*>(scales),
      static_cast<const float*>(lr), f, k, n, scale, wd, momentum, nesterov);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// p, g, m (n,) fp32; lr (1,) fp32 on the device -> po, mo (n,) fp32. The
// outputs may alias p / m (each element is read before it is written).
int fused_sgd(const void* p, const void* g, const void* m, const void* lr, void* po, void* mo,
              long long n, float momentum, int nesterov, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const Flat f = make_flat(p, m, nullptr, po, mo, g);
  fused_sgd_kernel<<<grid_for(n / VEC), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(lr), f, n, momentum, nesterov != 0);
  return cudaGetLastError();
}

// recv (k, n) in dtype (0 float32, 1 bfloat16, 2 float16, 3 int8 with
// scales (k,) fp32); p, m (n,) fp32; mask (n,) fp32 or NULL (no weight
// decay); lr (1,) fp32 on the device -> po, mo (n,) fp32.
int fused_rs_update(const void* recv, const void* scales, const void* p, const void* m,
                    const void* mask, const void* lr, void* po, void* mo, int k, long long n,
                    int dtype, float scale, float weight_decay, float momentum, int nesterov,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 0 || n <= 0 || (dtype == 3) != (scales != nullptr)) return cudaErrorInvalidValue;
  const Flat f = make_flat(p, m, weight_decay != 0.f ? mask : nullptr, po, mo, nullptr);
  const bool nv = nesterov != 0;
  switch (dtype) {
    case 0: return launch_rs<float>(recv, scales, lr, f, k, n, scale, weight_decay, momentum, nv, s);
    case 1: return launch_rs<__nv_bfloat16>(recv, scales, lr, f, k, n, scale, weight_decay, momentum, nv, s);
    case 2: return launch_rs<__half>(recv, scales, lr, f, k, n, scale, weight_decay, momentum, nv, s);
    case 3: return launch_rs<int8_t>(recv, scales, lr, f, k, n, scale, weight_decay, momentum, nv, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
