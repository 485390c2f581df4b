// Fused per-slot logit gather + greedy/temperature sampling for Hopper
// (sm_90a), in one launch. Plain C interface, loaded with ctypes
// (repro_torch/kernels/slot_gather.py); launches on the caller's stream and
// returns the launch's error.
//
// Replaces (JAX package, Pallas/TPU): src/repro/kernels/slot_gather.py:_kernel
//
// Per slot s:  row = sum_c onehot[s, c] * logits[s, c, :]  (rows of weight != 0)
//              greedy[s]  = argmax(row)
//              sampled[s] = argmax(row / max(T[s], 1e-6) + noise[s])
// with the first index winning ties, as jnp.argmax / torch.argmax do, and 0
// for a row with no value above -inf.
//
// What bounds it on an H100: reading the selected logit row and the Gumbel
// noise row once, 2 + 4 bytes a vocab entry at bf16 logits: memory, about
// 2 us for 8 slots at a vocab of 128 K-152 K. At that size the bytes cost
// less than a chain of dependent round trips, so the design removes round
// trips:
//  - One launch, no global scratch. The grid is (CL, S): a thread-block
//    cluster of CL <= 16 blocks a slot, each block on a slice of the vocab
//    (a multiple of 8 entries, the tail in the last block). The wrapper's
//    `sampler_plan` picks CL so that the S clusters fit the card at once:
//    a cluster's blocks share a GPC, and at one 512-thread block an SM an
//    H100 holds 7 clusters of 16 blocks and 15 of 8 (so 16 for the prefill
//    tail's one slot, 8 for 8 decode slots). Each block reduces its slice
//    to one (value, index) pair a argmax in shared memory; after a cluster
//    barrier, block rank 0 reads the pairs of its peers through
//    distributed shared memory and writes the slot's two indices.
//  - Every load of a thread in flight at once: the temperature, the one-hot
//    weight (C = 1: no scan of the row) and the noise are loaded with the
//    logits. 16-byte loads (8 logits at bf16/fp16, two float4 of noise),
//    UNITS of them a thread before the first compare: 12,288 entries a
//    block and round (the prefill tail's 8-10 K in one round, the decode's
//    16-19 K in two). C > 1 (the prefill tail) finds the selected rows with
//    one __ballot_sync a warp. A vocab that is not a multiple of 8, or a
//    logits or noise pointer off a 16-byte boundary, takes the same kernel
//    with scalar loads.
//  - The block's reduction in registers: warp shuffles, one shared write a
//    warp and one __syncthreads for both pairs together.
// The (value, index) order is total, so any split of the vocab and any
// reduction tree give the plain version's indices bit for bit.
//
// Built without fast math; __fdiv_rn/__fadd_rn make row / T + noise round
// as the plain version's IEEE division and addition do.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 8;            // entries a 16-byte load of bf16/fp16 logits
constexpr int MAX_CLUSTER = 16;   // an H100's largest (non-portable) cluster
constexpr unsigned FULL = 0xffffffffu;

// W consecutive entries of a row as loaded: W = VEC by 16-byte loads,
// W = 1 by scalar loads
template <typename T, int W> struct Unit { T a; };
template <> struct Unit<float, VEC> { float4 a, b; };
template <> struct Unit<__nv_bfloat16, VEC> { uint4 a; };
template <> struct Unit<__half, VEC> { uint4 a; };

template <typename T, int W>
__device__ __forceinline__ void load_unit(Unit<T, W>& u, const T* __restrict__ p) {
  if constexpr (W == 1) {
    u.a = p[0];
  } else if constexpr (sizeof(T) == 4) {
    u.a = __ldg(reinterpret_cast<const float4*>(p));
    u.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  } else {
    u.a = __ldg(reinterpret_cast<const uint4*>(p));
  }
}

__device__ __forceinline__ float f4_at(const float4& q, int e) {
  return e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w;
}
__device__ __forceinline__ unsigned u4_at(const uint4& q, int e) {
  return e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w;
}

// entry e of a unit as fp32 (e is a constant once the loops unroll)
template <typename T, int W>
__device__ __forceinline__ float unit_at(const Unit<T, W>& u, int e) {
  if constexpr (W == 1) {
    if constexpr (sizeof(T) == 4) return u.a;
    else if constexpr (std::is_same<T, __nv_bfloat16>::value) return __bfloat162float(u.a);
    else return __half2float(u.a);
  } else if constexpr (sizeof(T) == 4) {
    return f4_at(e < 4 ? u.a : u.b, e & 3);
  } else {
    const unsigned w = u4_at(u.a, e >> 1);   // entries 2k (low half) and 2k + 1
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
    else
      return __half2float(__ushort_as_half((unsigned short)((e & 1) ? (w >> 16) : (w & 0xffffu))));
  }
}

// (value, index) order: larger value wins, the lower index on equal values
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// both argmaxes over a warp, the shuffles of the two interleaved
__device__ __forceinline__ void warp_argmax2(float& gv, int& gi, float& sv, int& si) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ogv = __shfl_xor_sync(FULL, gv, o), osv = __shfl_xor_sync(FULL, sv, o);
    const int ogi = __shfl_xor_sync(FULL, gi, o), osi = __shfl_xor_sync(FULL, si, o);
    if (better(ogv, ogi, gv, gi)) {
      gv = ogv;
      gi = ogi;
    }
    if (better(osv, osi, sv, si)) {
      sv = osv;
      si = osi;
    }
  }
}

struct Pair {
  float v;
  int i;
};

// Block (rank r of the cluster, slot s) takes entries [r * slice, min(V, (r + 1) * slice)).
template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
sample_kernel(const T* __restrict__ logits, const float* __restrict__ onehot,
              const float* __restrict__ temp, const float* __restrict__ noise,
              int* __restrict__ greedy, int* __restrict__ sampled, int C, int V, int slice) {
  // units a thread keeps in flight (4 or 5 were no faster on an H100; 6 spill)
  constexpr int UNITS = W == VEC ? 3 : 16;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), s = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int v0 = rank * slice, n = (min(V, v0 + slice) - v0) / W;  // whole units
  // loads that need nothing else, issued before any is waited on
  const float t = fmaxf(temp[s], 1e-6f);
  const float w0 = C == 1 ? onehot[s] : 0.f;
  const float* oh = onehot + (size_t)s * C;
  const T* lg = logits + (size_t)s * C * V + v0;
  const float* nz = noise + (size_t)s * V + v0;

  // each thread walks its entries in increasing index order, so a strict
  // compare keeps the first index of its maximum; a thread that saw only
  // -inf keeps INT_MAX, which any real index beats
  float gv = -INFINITY, sv = -INFINITY;
  int gi = INT_MAX, si = INT_MAX;
  // rounds are block-uniform: the ballot below needs whole warps
  for (int r0 = 0; r0 < n; r0 += UNITS * THREADS) {
    Unit<float, W> nzu[UNITS];
    Unit<T, W> x[UNITS];
    float row[UNITS][W];
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int j = r0 + k * THREADS + (int)threadIdx.x;
      if (j < n) load_unit(nzu[k], nz + (size_t)j * W);
    }
    if (C == 1) {
#pragma unroll
      for (int k = 0; k < UNITS; ++k) {
        const int j = r0 + k * THREADS + (int)threadIdx.x;
        if (j < n) load_unit(x[k], lg + (size_t)j * W);
      }
#pragma unroll
      for (int k = 0; k < UNITS; ++k) {
        if (r0 + k * THREADS + (int)threadIdx.x >= n) continue;
#pragma unroll
        for (int e = 0; e < W; ++e)  // a row of weight 0 is skipped: exact zeros
          row[k][e] = w0 != 0.f ? __fadd_rn(0.f, __fmul_rn(unit_at(x[k], e), w0)) : 0.f;
      }
    } else {
#pragma unroll
      for (int k = 0; k < UNITS; ++k)
#pragma unroll
        for (int e = 0; e < W; ++e) row[k][e] = 0.f;
      for (int c0 = 0; c0 < C; c0 += 32) {
        const float wl = c0 + lane < C ? oh[c0 + lane] : 0.f;
        for (unsigned m = __ballot_sync(FULL, wl != 0.f); m; m &= m - 1) {
          const int b = __ffs(m) - 1;  // the selected rows in row order
          const float w = __shfl_sync(FULL, wl, b);
          const T* lr = lg + (size_t)(c0 + b) * V;
#pragma unroll
          for (int k = 0; k < UNITS; ++k) {
            const int j = r0 + k * THREADS + (int)threadIdx.x;
            if (j < n) load_unit(x[k], lr + (size_t)j * W);
          }
#pragma unroll
          for (int k = 0; k < UNITS; ++k) {
            if (r0 + k * THREADS + (int)threadIdx.x >= n) continue;
#pragma unroll
            for (int e = 0; e < W; ++e)
              row[k][e] = __fadd_rn(row[k][e], __fmul_rn(unit_at(x[k], e), w));
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int j = r0 + k * THREADS + (int)threadIdx.x;
      if (j < n) {
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const int i = v0 + j * W + e;
          const float r = row[k][e];
          if (r > gv) {
            gv = r;
            gi = i;
          }
          const float y = __fadd_rn(__fdiv_rn(r, t), unit_at(nzu[k], e));
          if (y > sv) {
            sv = y;
            si = i;
          }
        }
      }
    }
  }

  // the block's pairs: shuffles, one shared write a warp, one barrier
  __shared__ float wv[2][WARPS];
  __shared__ int wi[2][WARPS];
  __shared__ Pair part[2];  // this block's (greedy, sampled) pairs, read by rank 0
  warp_argmax2(gv, gi, sv, si);
  if (lane == 0) {
    wv[0][warp] = gv;
    wi[0][warp] = gi;
    wv[1][warp] = sv;
    wi[1][warp] = si;
  }
  __syncthreads();
  if (warp == 0) {
    gv = lane < WARPS ? wv[0][lane] : -INFINITY;
    gi = lane < WARPS ? wi[0][lane] : INT_MAX;
    sv = lane < WARPS ? wv[1][lane] : -INFINITY;
    si = lane < WARPS ? wi[1][lane] : INT_MAX;
    warp_argmax2(gv, gi, sv, si);
    if (lane == 0) {
      part[0] = Pair{gv, gi};
      part[1] = Pair{sv, si};
    }
  }
  cluster.sync();  // every block's pairs written and visible to the cluster
  if (rank == 0 && warp == 0) {
    gv = sv = -INFINITY;
    gi = si = INT_MAX;
    if (lane < (int)gridDim.x) {  // lane r reads the pairs of rank r
      const Pair* p = cluster.map_shared_rank(part, (unsigned)lane);
      gv = p[0].v;
      gi = p[0].i;
      sv = p[1].v;
      si = p[1].i;
    }
    warp_argmax2(gv, gi, sv, si);
    if (lane == 0) {
      greedy[s] = gi == INT_MAX ? 0 : gi;
      sampled[s] = si == INT_MAX ? 0 : si;
    }
  }
  cluster.sync();  // the peers stay resident until rank 0 has read their pairs
}

// The launch of `kern` as (cl, S) blocks in clusters of cl; `attr` holds
// the cluster's size. Above 8 blocks (the portable size) the kernel must be
// allowed the H100's non-portable clusters first.
template <typename K>
cudaError_t cluster_config(K kern, int cl, int S, cudaStream_t stream, cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  if (cl > 8) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cl, S, 1);
  cfg->blockDim = dim3(THREADS, 1, 1);
  cfg->dynamicSmemBytes = 0;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T, int W>
cudaError_t launch(const void* logits, const void* onehot, const void* temp, const void* noise,
                   void* greedy, void* sampled, int S, int C, int V, int cl, int slice,
                   cudaStream_t stream) {
  auto kern = sample_kernel<T, W>;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t e = cluster_config(kern, cl, S, stream, &attr, &cfg);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(logits),
                         static_cast<const float*>(onehot), static_cast<const float*>(temp),
                         static_cast<const float*>(noise), static_cast<int*>(greedy),
                         static_cast<int*>(sampled), C, V, slice);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

template <typename T>
cudaError_t dispatch(bool vec, const void* logits, const void* onehot, const void* temp,
                     const void* noise, void* greedy, void* sampled, int S, int C, int V, int cl,
                     int slice, cudaStream_t stream) {
  return vec ? launch<T, VEC>(logits, onehot, temp, noise, greedy, sampled, S, C, V, cl, slice, stream)
             : launch<T, 1>(logits, onehot, temp, noise, greedy, sampled, S, C, V, cl, slice, stream);
}

}  // namespace

extern "C" {

// logits (S, C, V) in dtype (0 float32, 1 bfloat16, 2 float16); onehot
// (S, C), temp (S,), noise (S, V) fp32; greedy/sampled (S,) int32. The slot's
// vocab is cut into cl slices of `slice` entries (a multiple of 8; the last
// may be shorter and none is empty), one block of the slot's cluster each.
int slot_gather_sample(const void* logits, const void* onehot, const void* temp,
                       const void* noise, void* greedy, void* sampled, int S, int C, int V,
                       int cl, int slice, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || S > 65535 || C <= 0 || V <= 0 || cl < 1 || cl > MAX_CLUSTER || slice <= 0 ||
      slice % VEC != 0 || (long long)cl * slice < V || (long long)(cl - 1) * slice >= V)
    return cudaErrorInvalidValue;
  // 16-byte loads need whole units in every row and aligned row starts
  const bool vec = V % VEC == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(noise) % 16 == 0;
  switch (dtype) {
    case 0: return dispatch<float>(vec, logits, onehot, temp, noise, greedy, sampled, S, C, V, cl, slice, st);
    case 1: return dispatch<__nv_bfloat16>(vec, logits, onehot, temp, noise, greedy, sampled, S, C, V, cl, slice, st);
    case 2: return dispatch<__half>(vec, logits, onehot, temp, noise, greedy, sampled, S, C, V, cl, slice, st);
  }
  return cudaErrorInvalidValue;
}

// *n = the clusters of cl blocks of the bf16 16-byte kernel that the card
// holds at once (cudaOccupancyMaxActiveClusters): what sampler_plan's rule
// assumes of an H100, as the card reports it.
int slot_gather_max_clusters(int cl, int* n) {
  if (cl < 1 || cl > MAX_CLUSTER) return cudaErrorInvalidValue;
  auto kern = sample_kernel<__nv_bfloat16, VEC>;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const cudaError_t e = cluster_config(kern, cl, 1, nullptr, &attr, &cfg);
  return e != cudaSuccess ? e : cudaOccupancyMaxActiveClusters(n, kern, &cfg);
}

}  // extern "C"
