// Fused per-slot logit gather + greedy/temperature sampling for Hopper
// (sm_90a). Plain C interface, loaded with ctypes
// (repro_torch/kernels/slot_gather.py); launches on the caller's stream and
// returns cudaGetLastError().
//
// Replaces (JAX package, Pallas/TPU): src/repro/kernels/slot_gather.py:_kernel
//
// Per slot s:  row = sum_c onehot[s, c] * logits[s, c, :]
//              greedy[s]  = argmax(row)
//              sampled[s] = argmax(row / max(T[s], 1e-6) + noise[s])
// with the first index winning ties, as jnp.argmax / torch.argmax do.
//
// What bounds it on an H100: reading the gathered logit row and the Gumbel
// noise row once (2 + 4 bytes per vocab entry at bf16 logits) -- a handful
// of flops per byte, so memory bandwidth. A row of 128 K entries is far too
// little work for one SM to stream at the card's rate, so pass 1 cuts every
// slot's row into chunks of `chunk` entries, one block each (8 slots x 32
// chunks = 256 blocks at the decode shape): each block keeps the running
// (value, index) pairs in registers and reduces them over the block. Pass 2
// reduces each slot's chunk partials in chunk order. Logits are read once
// and no gathered (S, V) row is written back. Only the one-hot rows with a
// non-zero weight are read, so the prefill tail (C = chunk rows) reads one
// row, not C.
//
// Built without fast math, and the transform uses __fdiv_rn/__fadd_rn: the
// sampled index must equal the plain version's IEEE row / T + noise exactly.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }

// (value, index) order: larger value wins, the lower index on equal values
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Reduce one (value, index) pair per thread over the block; the result is
// valid in thread 0. `wv`/`wi` are WARPS-long shared scratch.
__device__ __forceinline__ void block_argmax(float& v, int& i, float* wv, int* wi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  warp_argmax(v, i);
  __syncthreads();  // the scratch may still be read from a previous call
  if (lane == 0) {
    wv[warp] = v;
    wi[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? wv[lane] : -INFINITY;
    i = lane < WARPS ? wi[lane] : INT_MAX;
    warp_argmax(v, i);
  }
}

// pass 1: block (chunk j, slot s) -> partial pairs at part[(s * nchunk + j) * 2 + {0: greedy, 1: sampled}]
template <typename T>
__global__ void __launch_bounds__(THREADS)
chunk_kernel(const T* __restrict__ logits, const float* __restrict__ onehot,
             const float* __restrict__ temp, const float* __restrict__ noise,
             float* __restrict__ part_v, int* __restrict__ part_i, int C, int V, int chunk) {
  const int j = blockIdx.x, s = blockIdx.y, nchunk = gridDim.x;
  extern __shared__ unsigned char smem[];
  int* sel_c = reinterpret_cast<int*>(smem);                 // [C] rows with weight != 0
  float* sel_w = reinterpret_cast<float*>(sel_c + C);        // [C] their weights
  __shared__ int n_sel;
  __shared__ float wv[WARPS];
  __shared__ int wi[WARPS];
  if (threadIdx.x == 0) {
    int n = 0;
    for (int c = 0; c < C; ++c) {
      const float w = onehot[(size_t)s * C + c];
      if (w != 0.f) {
        sel_c[n] = c;
        sel_w[n] = w;
        ++n;
      }
    }
    n_sel = n;
  }
  __syncthreads();

  const float t = fmaxf(temp[s], 1e-6f);
  const T* lg = logits + (size_t)s * C * V;
  const float* nz = noise + (size_t)s * V;
  const int v0 = j * chunk, v1 = min(V, v0 + chunk);
  float gv = -INFINITY, sv = -INFINITY;
  int gi = INT_MAX, si = INT_MAX;
  for (int i = v0 + threadIdx.x; i < v1; i += THREADS) {
    float row = 0.f;  // the skipped rows add exact zeros
    for (int u = 0; u < n_sel; ++u)
      row = __fadd_rn(row, __fmul_rn(to_f<T>(lg[(size_t)sel_c[u] * V + i]), sel_w[u]));
    if (better(row, i, gv, gi)) {
      gv = row;
      gi = i;
    }
    const float x = __fadd_rn(__fdiv_rn(row, t), nz[i]);
    if (better(x, i, sv, si)) {
      sv = x;
      si = i;
    }
  }
  block_argmax(gv, gi, wv, wi);
  block_argmax(sv, si, wv, wi);
  if (threadIdx.x == 0) {  // thread 0 holds both block results
    const size_t o = ((size_t)s * nchunk + j) * 2;
    part_v[o] = gv;
    part_i[o] = gi;
    part_v[o + 1] = sv;
    part_i[o + 1] = si;
  }
}

// pass 2: one warp per slot folds its chunk partials in chunk order
__global__ void __launch_bounds__(32)
finish_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
              int* __restrict__ greedy, int* __restrict__ sampled, int nchunk) {
  const int s = blockIdx.x, lane = threadIdx.x;
  for (int which = 0; which < 2; ++which) {
    float v = -INFINITY;
    int i = INT_MAX;
    for (int j = lane; j < nchunk; j += 32) {
      const size_t o = ((size_t)s * nchunk + j) * 2 + which;
      if (better(part_v[o], part_i[o], v, i)) {
        v = part_v[o];
        i = part_i[o];
      }
    }
    warp_argmax(v, i);
    if (lane == 0) (which == 0 ? greedy : sampled)[s] = i == INT_MAX ? 0 : i;
  }
}

template <typename T>
cudaError_t launch(const void* logits, const void* onehot, const void* temp, const void* noise,
                   void* greedy, void* sampled, void* part_v, void* part_i, int S, int C,
                   int V, int chunk, cudaStream_t stream) {
  const int nchunk = (V + chunk - 1) / chunk;
  const size_t smem = (size_t)C * (sizeof(int) + sizeof(float));
  auto kern = chunk_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(nchunk, S), THREADS, smem, stream>>>(
      static_cast<const T*>(logits), static_cast<const float*>(onehot),
      static_cast<const float*>(temp), static_cast<const float*>(noise),
      static_cast<float*>(part_v), static_cast<int*>(part_i), C, V, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  finish_kernel<<<S, 32, 0, stream>>>(static_cast<const float*>(part_v),
                                      static_cast<const int*>(part_i),
                                      static_cast<int*>(greedy), static_cast<int*>(sampled),
                                      nchunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// logits (S, C, V) in dtype (0 float32, 1 bfloat16, 2 float16); onehot
// (S, C), temp (S,), noise (S, V) fp32; greedy/sampled (S,) int32.
// Scratch from the caller: part_v fp32 and part_i int32, each
// S * ceil(V / chunk) * 2 entries.
int slot_gather_sample(const void* logits, const void* onehot, const void* temp,
                       const void* noise, void* greedy, void* sampled, void* part_v,
                       void* part_i, int S, int C, int V, int chunk, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 0 || C <= 0 || V <= 0 || chunk <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float>(logits, onehot, temp, noise, greedy, sampled, part_v, part_i, S, C, V, chunk, s);
    case 1: return launch<__nv_bfloat16>(logits, onehot, temp, noise, greedy, sampled, part_v, part_i, S, C, V, chunk, s);
    case 2: return launch<__half>(logits, onehot, temp, noise, greedy, sampled, part_v, part_i, S, C, V, chunk, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
