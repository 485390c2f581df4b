// Flash attention for Hopper (sm_90a): the causal/windowed GQA forward used
// by training and chunked prefill, its backward (dq, and dk/dv), and the
// split-KV one-token decode over contiguous or paged cache lanes. Plain C
// interface, loaded with ctypes
// (repro_torch/kernels/flash_attention.py); every entry point launches on
// the caller's stream and returns cudaGetLastError().
//
// Replaces (JAX package, Pallas/TPU):
//   flash_fwd          <- src/repro/kernels/flash_attention.py:_fwd_kernel
//   flash_bwd_dq       <- src/repro/kernels/flash_attention.py:_dq_kernel
//   flash_bwd_dkv      <- src/repro/kernels/flash_attention.py:_dkv_kernel
//   flash_decode_split <- src/repro/kernels/flash_attention.py:_decode_kernel
//                         and :_decode_paged_kernel (tables != NULL)
//
// What bounds them on an H100: at the serve path's shapes (one 32-row
// prefill chunk over a <=1 K-row lane; 8 one-token decode rows per step)
// both are bound by reading K/V from device memory -- 2*G score FLOPs per
// key byte read is far below the ~295 FLOP/byte where bf16 tensor cores
// become the limit. The design therefore reads each live K/V row once per
// (kv head, q tile) block, folds the G query heads of a KV group into the
// rows of one block (as the TPU kernel folds them into its q tile), skips
// key tiles above the causal diagonal or below the window, and never writes
// a score matrix to device memory. Products are fp32 FMAs on values staged
// in shared memory; a tensor-core (wgmma/mma.sync) version is later work.
// The backward's bound and design are noted above its kernels.
//
// Numerics follow the TPU kernels: fp32 online softmax, NEG_INF = -1e30,
// masked p zeroed explicitly, l clamped at 1e-30, and p rounded to the
// value dtype before the PV product.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

namespace {

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// p.astype(v.dtype) before the PV product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool window_keep(int qpos, int kpos, int win) {
  return win <= 0 || qpos - kpos < win;
}

// ---------------------------------------------------------------------------
// forward: one block per (q tile, kv head, batch row)
// ---------------------------------------------------------------------------

constexpr int FWD_THREADS = 128;           // 4 warps
constexpr int FWD_WARPS = FWD_THREADS / 32;
// Row capacity of a block: block_q = FWD_ROWS / G queries of G heads each,
// block_q * G rows; where G does not divide FWD_ROWS (G = 3: 15 rows) the
// spare rows stay idle. Small on purpose: a 32-row prefill chunk of
// llama3.2-1b (G = 4) then spreads over 8 q tiles x 8 kv heads = 64
// blocks instead of 16, and each lane's serial FMA chain is 4x shorter.
constexpr int FWD_ROWS = 16;
constexpr int FWD_RPW = FWD_ROWS / FWD_WARPS;
constexpr int FWD_BK = 32;                 // keys per tile: one per lane

template <typename T, int D>
__global__ void __launch_bounds__(FWD_THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ out, float* __restrict__ lse, const int* __restrict__ q_off,
           int Sq, int Sk, int H, int KV, int block_q, int win, float sm_scale) {
  constexpr int DPL = D / 32;  // output columns per lane
  const int G = H / KV;
  const int rows = block_q * G;
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qoff = q_off[b];

  extern __shared__ float smem[];
  float* qs = smem;                      // [FWD_ROWS][D]
  float* ks = qs + FWD_ROWS * D;         // [FWD_BK][D + 1] (padded: no bank conflicts)
  float* vs = ks + FWD_BK * (D + 1);     // [FWD_BK][D]
  float* ps = vs + FWD_BK * D;           // [FWD_ROWS][FWD_BK]

  // row r of the tile is (query i*block_q + r/G, head h*G + r%G): the G
  // heads of a query are adjacent in the (B, Sq, H, D) layout
  for (int e = threadIdx.x; e < FWD_ROWS * D; e += FWD_THREADS) {
    const int r = e / D, d = e % D;
    const int qi = i * block_q + r / G;
    float x = 0.f;
    if (r < rows && qi < Sq)
      x = to_f<T>(q[(((size_t)b * Sq + qi) * H + h * G + r % G) * D + d]);
    qs[e] = x;
  }

  float m[FWD_RPW], l[FWD_RPW], acc[FWD_RPW][DPL];
#pragma unroll
  for (int t = 0; t < FWD_RPW; ++t) {
    m[t] = NEG_INF;
    l[t] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[t][dd] = 0.f;
  }

  const int nk = (Sk + FWD_BK - 1) / FWD_BK;
  const int last_q = qoff + (i + 1) * block_q - 1;  // newest query of the tile
  const int j_hi = min(nk - 1, last_q / FWD_BK);    // causal tile skip
  const int first_q = qoff + i * block_q;
  for (int j = 0; j <= j_hi; ++j) {
    // window tile skip (_tile_live); uniform over the block
    if (win > 0 && (j + 1) * FWD_BK <= first_q - win + 1) continue;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int e = threadIdx.x; e < FWD_BK * D; e += FWD_THREADS) {
      const int c = e / D, d = e % D;
      const int kpos = j * FWD_BK + c;
      float kx = 0.f, vx = 0.f;
      if (kpos < Sk) {
        const size_t off = (((size_t)b * Sk + kpos) * KV + h) * D + d;
        kx = to_f<T>(k[off]);
        vx = to_f<T>(v[off]);
      }
      ks[c * (D + 1) + d] = kx;
      vs[c * D + d] = vx;
    }
    __syncthreads();

    float s[FWD_RPW];
#pragma unroll
    for (int t = 0; t < FWD_RPW; ++t) s[t] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane * (D + 1) + d];
#pragma unroll
      for (int t = 0; t < FWD_RPW; ++t) s[t] += qs[(warp + FWD_WARPS * t) * D + d] * kd;
    }
    const int kpos = j * FWD_BK + lane;
#pragma unroll
    for (int t = 0; t < FWD_RPW; ++t) {
      const int r = warp + FWD_WARPS * t;
      const int qpos = qoff + i * block_q + r / G;
      const bool keep = kpos <= qpos && kpos < Sk && window_keep(qpos, kpos, win);
      const float sv = keep ? s[t] * sm_scale : NEG_INF;
      const float m_next = fmaxf(m[t], warp_max(sv));
      // explicit zeroing: while every key so far is masked m_next is still
      // NEG_INF and exp(sv - m_next) would be 1, not 0
      const float p = keep ? expf(sv - m_next) : 0.f;
      const float alpha = expf(m[t] - m_next);
      l[t] = alpha * l[t] + warp_sum(p);
      m[t] = m_next;
      ps[r * FWD_BK + lane] = round_to<T>(p);
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[t][dd] *= alpha;
    }
    __syncwarp();
    for (int c = 0; c < FWD_BK; ++c) {
      float vv[DPL];
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) vv[dd] = vs[c * D + lane + 32 * dd];
#pragma unroll
      for (int t = 0; t < FWD_RPW; ++t) {
        const float pc = ps[(warp + FWD_WARPS * t) * FWD_BK + c];
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[t][dd] += pc * vv[dd];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int t = 0; t < FWD_RPW; ++t) {
    const int r = warp + FWD_WARPS * t;
    const int qi = i * block_q + r / G;
    if (r >= rows || qi >= Sq) continue;
    const size_t row = ((size_t)b * Sq + qi) * H + h * G + r % G;
    const float lc = fmaxf(l[t], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) out[row * D + lane + 32 * dd] = from_f<T>(acc[t][dd] / lc);
    if (lse != nullptr && lane == 0) lse[row] = m[t] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// backward: dq, and dk/dv summed over the G heads of a group
// ---------------------------------------------------------------------------
//
// Both recompute p = exp(s * sm_scale - lse) per tile from the saved fp32
// lse (never stored), with ds = p * (dp - di) * sm_scale, dp = do . v and
// di = rowsum(out * do) computed by the caller. Casts follow the TPU
// kernels: ds to k's dtype before ds @ k (dq), p to do's dtype and ds to
// q's dtype before the dv / dk contractions. At the training shapes
// (B 4, S 1024, 32 heads over 8, D 64) both are bound by operations (~6D
// and ~8D FLOPs per live (row, key) pair against ~4 bytes of input per
// row and key column); these first versions run them as fp32 FMAs on the
// CUDA cores from shared memory, like the forward, and a tensor-core
// version is later work.

constexpr int BWD_THREADS = 128;           // 4 warps
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_BK = 32;                 // keys per tile: one per lane
// dq: one block per (q tile, kv head, batch row), rows = (DQ_ROWS / G) * G
constexpr int DQ_ROWS = 16;
constexpr int DQ_RPW = DQ_ROWS / BWD_WARPS;
// dk/dv: one block per (key tile, kv head, batch row) walking q tiles of
// (DKV_ROWS / G) * G rows; each warp owns BWD_BK / BWD_WARPS keys of the
// tile, so dk/dv are summed over the whole group in registers, no atomics
constexpr int DKV_ROWS = 32;
constexpr int DKV_RPW = DKV_ROWS / BWD_WARPS;
constexpr int DKV_KPW = BWD_BK / BWD_WARPS;

// the rows of one q tile of a (B, Sq, H, D) tensor, G heads per query,
// into shared memory as fp32 (zeros past Sq and in the spare rows)
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int b, int i,
                                          int Sq, int H, int h, int G, int block_q) {
  const int rows = block_q * G;
  for (int e = threadIdx.x; e < ROWS * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    const int qi = i * block_q + r / G;
    float x = 0.f;
    if (r < rows && qi < Sq) x = to_f<T>(src[(((size_t)b * Sq + qi) * H + h * G + r % G) * D + d]);
    dst[e] = x;
  }
}

template <int ROWS>
__device__ __forceinline__ void load_row_stats(float* dst, const float* __restrict__ src, int b,
                                               int i, int Sq, int H, int h, int G, int block_q) {
  const int rows = block_q * G;
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    const int qi = i * block_q + r / G;
    dst[r] = (r < rows && qi < Sq) ? src[((size_t)b * Sq + qi) * H + h * G + r % G] : 0.f;
  }
}

// keys [j*BWD_BK, (j+1)*BWD_BK) of kv head h of a (B, Sk, KV, D) tensor,
// padded rows of D + 1 (no bank conflicts when lane = key)
template <typename T, int D>
__device__ __forceinline__ void load_keys(float* dst, const T* __restrict__ src, int b, int j,
                                          int Sk, int KV, int h) {
  for (int e = threadIdx.x; e < BWD_BK * D; e += blockDim.x) {
    const int c = e / D, d = e % D;
    const int kpos = j * BWD_BK + c;
    dst[c * (D + 1) + d] =
        kpos < Sk ? to_f<T>(src[(((size_t)b * Sk + kpos) * KV + h) * D + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ di, T* __restrict__ dq, const int* __restrict__ q_off,
              int Sq, int Sk, int H, int KV, int block_q, int win, float sm_scale) {
  constexpr int DPL = D / 32;
  const int G = H / KV;
  const int rows = block_q * G;
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int first_q = q_off[b] + i * block_q;   // oldest query of the tile

  extern __shared__ float smem[];
  float* qs = smem;                        // [DQ_ROWS][D]
  float* dos = qs + DQ_ROWS * D;           // [DQ_ROWS][D]
  float* ks = dos + DQ_ROWS * D;           // [BWD_BK][D + 1]
  float* vs = ks + BWD_BK * (D + 1);       // [BWD_BK][D + 1]
  float* dss = vs + BWD_BK * (D + 1);      // [DQ_ROWS][BWD_BK]
  float* lses = dss + DQ_ROWS * BWD_BK;    // [DQ_ROWS]
  float* dis = lses + DQ_ROWS;             // [DQ_ROWS]

  load_rows<T, D, DQ_ROWS>(qs, q, b, i, Sq, H, h, G, block_q);
  load_rows<T, D, DQ_ROWS>(dos, dout, b, i, Sq, H, h, G, block_q);
  load_row_stats<DQ_ROWS>(lses, lse, b, i, Sq, H, h, G, block_q);
  load_row_stats<DQ_ROWS>(dis, di, b, i, Sq, H, h, G, block_q);

  float acc[DQ_RPW][DPL];
#pragma unroll
  for (int t = 0; t < DQ_RPW; ++t)
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[t][dd] = 0.f;

  const int nk = (Sk + BWD_BK - 1) / BWD_BK;
  const int j_hi = min(nk - 1, (first_q + block_q - 1) / BWD_BK);  // causal tile skip
  for (int j = 0; j <= j_hi; ++j) {
    // window tile skip (_tile_live); uniform over the block
    if (win > 0 && (j + 1) * BWD_BK <= first_q - win + 1) continue;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_keys<T, D>(ks, k, b, j, Sk, KV, h);
    load_keys<T, D>(vs, v, b, j, Sk, KV, h);
    __syncthreads();

    // s = q . k and dp = do . v: lane = key, warp = rows warp + 4t
    float s[DQ_RPW], dp[DQ_RPW];
#pragma unroll
    for (int t = 0; t < DQ_RPW; ++t) s[t] = dp[t] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane * (D + 1) + d], vd = vs[lane * (D + 1) + d];
#pragma unroll
      for (int t = 0; t < DQ_RPW; ++t) {
        const int r = warp + BWD_WARPS * t;
        s[t] += qs[r * D + d] * kd;
        dp[t] += dos[r * D + d] * vd;
      }
    }
    const int kpos = j * BWD_BK + lane;
#pragma unroll
    for (int t = 0; t < DQ_RPW; ++t) {
      const int r = warp + BWD_WARPS * t;
      const int qpos = first_q + r / G;
      const bool keep = r < rows && i * block_q + r / G < Sq && kpos <= qpos && kpos < Sk &&
                        window_keep(qpos, kpos, win);
      const float p = keep ? expf(s[t] * sm_scale - lses[r]) : 0.f;
      dss[r * BWD_BK + lane] = round_to<T>(p * (dp[t] - dis[r]) * sm_scale);
    }
    __syncwarp();
    // dq[r][d] += sum_c ds[r][c] * k[c][d]: lane = column d
    for (int c = 0; c < BWD_BK; ++c) {
      float kk[DPL];
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) kk[dd] = ks[c * (D + 1) + lane + 32 * dd];
#pragma unroll
      for (int t = 0; t < DQ_RPW; ++t) {
        const float dsc = dss[(warp + BWD_WARPS * t) * BWD_BK + c];
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[t][dd] += dsc * kk[dd];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int t = 0; t < DQ_RPW; ++t) {
    const int r = warp + BWD_WARPS * t;
    const int qi = i * block_q + r / G;
    if (r >= rows || qi >= Sq) continue;
    const size_t row = ((size_t)b * Sq + qi) * H + h * G + r % G;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) dq[row * D + lane + 32 * dd] = from_f<T>(acc[t][dd]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
               const int* __restrict__ q_off, int Sq, int Sk, int H, int KV, int block_q,
               int win, float sm_scale) {
  constexpr int DPL = D / 32;
  const int G = H / KV;
  const int rows = block_q * G;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qoff = q_off[b];

  extern __shared__ float smem[];
  float* ks = smem;                        // [BWD_BK][D + 1]
  float* vs = ks + BWD_BK * (D + 1);       // [BWD_BK][D + 1]
  float* qs = vs + BWD_BK * (D + 1);       // [DKV_ROWS][D]
  float* dos = qs + DKV_ROWS * D;          // [DKV_ROWS][D]
  float* ps = dos + DKV_ROWS * D;          // [DKV_ROWS][BWD_BK]
  float* dss = ps + DKV_ROWS * BWD_BK;     // [DKV_ROWS][BWD_BK]
  float* lses = dss + DKV_ROWS * BWD_BK;   // [DKV_ROWS]
  float* dis = lses + DKV_ROWS;            // [DKV_ROWS]

  load_keys<T, D>(ks, k, b, j, Sk, KV, h);
  load_keys<T, D>(vs, v, b, j, Sk, KV, h);

  float acc_k[DKV_KPW][DPL], acc_v[DKV_KPW][DPL];
#pragma unroll
  for (int u = 0; u < DKV_KPW; ++u)
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc_k[u][dd] = acc_v[u][dd] = 0.f;

  const int nq = (Sq + block_q - 1) / block_q;
  const int kpos = j * BWD_BK + lane;
  for (int i = 0; i < nq; ++i) {
    const int first_q = qoff + i * block_q;
    // _tile_live: not above the causal diagonal, not older than the window
    if (j * BWD_BK > first_q + block_q - 1) continue;
    if (win > 0 && (j + 1) * BWD_BK <= first_q - win + 1) continue;
    __syncthreads();  // every warp is done with the previous q tile
    load_rows<T, D, DKV_ROWS>(qs, q, b, i, Sq, H, h, G, block_q);
    load_rows<T, D, DKV_ROWS>(dos, dout, b, i, Sq, H, h, G, block_q);
    load_row_stats<DKV_ROWS>(lses, lse, b, i, Sq, H, h, G, block_q);
    load_row_stats<DKV_ROWS>(dis, di, b, i, Sq, H, h, G, block_q);
    __syncthreads();

    // s = q . k and dp = do . v: lane = key, warp = rows warp + 4t
    float s[DKV_RPW], dp[DKV_RPW];
#pragma unroll
    for (int t = 0; t < DKV_RPW; ++t) s[t] = dp[t] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane * (D + 1) + d], vd = vs[lane * (D + 1) + d];
#pragma unroll
      for (int t = 0; t < DKV_RPW; ++t) {
        const int r = warp + BWD_WARPS * t;
        s[t] += qs[r * D + d] * kd;
        dp[t] += dos[r * D + d] * vd;
      }
    }
#pragma unroll
    for (int t = 0; t < DKV_RPW; ++t) {
      const int r = warp + BWD_WARPS * t;
      const int qpos = first_q + r / G;
      const bool keep = r < rows && i * block_q + r / G < Sq && kpos <= qpos && kpos < Sk &&
                        window_keep(qpos, kpos, win);
      const float p = keep ? expf(s[t] * sm_scale - lses[r]) : 0.f;
      ps[r * BWD_BK + lane] = round_to<T>(p);
      dss[r * BWD_BK + lane] = round_to<T>(p * (dp[t] - dis[r]) * sm_scale);
    }
    __syncthreads();  // the contractions read every warp's rows

    // dv[c][d] += sum_r p[r][c] do[r][d], dk[c][d] += sum_r ds[r][c] q[r][d]:
    // warp = keys c = warp * DKV_KPW + u, lane = column d
    for (int r = 0; r < rows; ++r) {
      float dov[DPL], qv[DPL];
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) {
        dov[dd] = dos[r * D + lane + 32 * dd];
        qv[dd] = qs[r * D + lane + 32 * dd];
      }
#pragma unroll
      for (int u = 0; u < DKV_KPW; ++u) {
        const int c = warp * DKV_KPW + u;
        const float pc = ps[r * BWD_BK + c], dsc = dss[r * BWD_BK + c];
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) {
          acc_v[u][dd] += pc * dov[dd];
          acc_k[u][dd] += dsc * qv[dd];
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < DKV_KPW; ++u) {
    const int kp = j * BWD_BK + warp * DKV_KPW + u;
    if (kp >= Sk) continue;
    const size_t row = ((size_t)b * Sk + kp) * KV + h;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      dk[row * D + lane + 32 * dd] = from_f<T>(acc_k[u][dd]);
      dv[row * D + lane + 32 * dd] = from_f<T>(acc_v[u][dd]);
    }
  }
}

// ---------------------------------------------------------------------------
// split-KV decode: one block per (split, kv head, slot)
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_MAX_G = 16;
constexpr int DEC_RPW = DEC_MAX_G / DEC_WARPS;
constexpr int DEC_SUB = 32;  // keys staged in shared memory at a time

// Split j of slot b covers logical keys [j*block_k, (j+1)*block_k). Its rows
// start at row `base` of a (rows, KV, D) array: b*S + j*block_k in the
// contiguous lanes (B, S, KV, D), or tables[b, j]*page_size in the pages
// (P, page_size, KV, D) with block_k == page_size. Everything else is the
// same code, so the paged result is bit-identical to the contiguous one on
// the gathered lanes with block_k = page_size.
template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ tables, const int* __restrict__ pos,
              float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ acc_out,
              int H, int KV, int S, int NP, int block_k, int kv_len, int win, float sm_scale) {
  constexpr int DPL = D / 32;
  const int G = H / KV;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ns = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p_b = pos[b];
  const size_t part = ((size_t)b * KV + h) * ns + j;  // (B, KV, ns) index

  // _tile_live(0, j, pos, win, 1, block_k): dead splits write the neutral
  // partial (m=NEG_INF, l=0, acc=0), which drops out of the combine exactly
  const bool live = j * block_k <= p_b && (win <= 0 || (j + 1) * block_k > p_b - win + 1);
  if (!live) {
    for (int e = threadIdx.x; e < G * D; e += DEC_THREADS) acc_out[part * G * D + e] = 0.f;
    for (int g = threadIdx.x; g < G; g += DEC_THREADS) {
      m_out[part * G + g] = NEG_INF;
      l_out[part * G + g] = 0.f;
    }
    return;
  }
  const size_t base = tables != nullptr ? (size_t)tables[(size_t)b * NP + j] * block_k
                                        : (size_t)b * S + (size_t)j * block_k;

  extern __shared__ float smem[];
  float* qs = smem;                    // [G][D]
  float* ks = qs + DEC_MAX_G * D;      // [DEC_SUB][D + 1]
  float* vs = ks + DEC_SUB * (D + 1);  // [DEC_SUB][D]
  float* sc = vs + DEC_SUB * D;        // [G][block_k] scores, then p

  for (int e = threadIdx.x; e < G * D; e += DEC_THREADS)
    qs[e] = to_f<T>(q[((size_t)b * H + h * G) * D + e]);

  // scores: lane = key, warp = query rows g = warp + DEC_WARPS*u
  for (int st = 0; st < block_k; st += DEC_SUB) {
    __syncthreads();
    for (int e = threadIdx.x; e < DEC_SUB * D; e += DEC_THREADS) {
      const int c = e / D, d = e % D;
      const int kp = j * block_k + st + c;
      float kx = 0.f;
      if (st + c < block_k && kp < kv_len) kx = to_f<T>(k[((base + st + c) * KV + h) * D + d]);
      ks[c * (D + 1) + d] = kx;
    }
    __syncthreads();
    const int c = st + lane;
    if (c < block_k) {
      const int kp = j * block_k + c;
      const bool keep = kp <= p_b && kp < kv_len && window_keep(p_b, kp, win);
#pragma unroll
      for (int u = 0; u < DEC_RPW; ++u) {
        const int g = warp + DEC_WARPS * u;
        if (g >= G) break;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s += qs[g * D + d] * ks[lane * (D + 1) + d];
        sc[g * block_k + c] = keep ? s * sm_scale : NEG_INF;
      }
    }
  }
  __syncthreads();

  // softmax statistics of the split, per query row (one warp per row)
  float l_row[DEC_RPW];
#pragma unroll
  for (int u = 0; u < DEC_RPW; ++u) {
    const int g = warp + DEC_WARPS * u;
    l_row[u] = 0.f;
    if (g >= G) break;
    float mx = NEG_INF;
    for (int c = lane; c < block_k; c += 32) mx = fmaxf(mx, sc[g * block_k + c]);
    mx = warp_max(mx);
    float ls = 0.f;
    for (int c = lane; c < block_k; c += 32) {
      const int kp = j * block_k + c;
      const bool keep = kp <= p_b && kp < kv_len && window_keep(p_b, kp, win);
      const float p = keep ? expf(sc[g * block_k + c] - mx) : 0.f;
      ls += p;
      sc[g * block_k + c] = round_to<T>(p);
    }
    l_row[u] = warp_sum(ls);
    if (lane == 0) {
      m_out[part * G + g] = mx;
      l_out[part * G + g] = l_row[u];
    }
  }

  // acc[g][d] = sum_c p[g][c] * v[c][d]
  float acc[DEC_RPW][DPL];
#pragma unroll
  for (int u = 0; u < DEC_RPW; ++u)
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[u][dd] = 0.f;
  for (int st = 0; st < block_k; st += DEC_SUB) {
    __syncthreads();
    for (int e = threadIdx.x; e < DEC_SUB * D; e += DEC_THREADS) {
      const int c = e / D, d = e % D;
      const int kp = j * block_k + st + c;
      float vx = 0.f;
      if (st + c < block_k && kp < kv_len) vx = to_f<T>(v[((base + st + c) * KV + h) * D + d]);
      vs[c * D + d] = vx;
    }
    __syncthreads();
    const int n = min(DEC_SUB, block_k - st);
#pragma unroll
    for (int u = 0; u < DEC_RPW; ++u) {
      const int g = warp + DEC_WARPS * u;
      if (g >= G) break;
      for (int c = 0; c < n; ++c) {
        const float pc = sc[g * block_k + st + c];
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[u][dd] += pc * vs[c * D + lane + 32 * dd];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < DEC_RPW; ++u) {
    const int g = warp + DEC_WARPS * u;
    if (g >= G) break;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd)
      acc_out[(part * G + g) * D + lane + 32 * dd] = acc[u][dd];
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                       const void* q_off, int B, int Sq, int Sk, int H, int KV, int win,
                       float sm_scale, cudaStream_t stream) {
  const int G = H / KV;
  const int block_q = FWD_ROWS / G;
  const size_t smem = sizeof(float) * (FWD_ROWS * D + FWD_BK * (D + 1) + FWD_BK * D +
                                       FWD_ROWS * FWD_BK);
  auto kern = fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + block_q - 1) / block_q, KV, B);
  kern<<<grid, FWD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), static_cast<const int*>(q_off), Sq, Sk, H,
      KV, block_q, win, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const void* tables,
                          const void* pos, void* m, void* l, void* acc, int B, int H, int KV,
                          int S, int NP, int block_k, int ns, int kv_len, int win,
                          float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (DEC_MAX_G * D + DEC_SUB * (D + 1) + DEC_SUB * D +
                                       (size_t)(H / KV) * block_k);
  auto kern = decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(ns, KV, B);
  kern<<<grid, DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(tables), static_cast<const int*>(pos), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(acc), H, KV, S, NP, block_k, kv_len, win,
      sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* di, void* dq, const void* q_off, int B,
                          int Sq, int Sk, int H, int KV, int win, float sm_scale,
                          cudaStream_t stream) {
  const int block_q = DQ_ROWS / (H / KV);
  const size_t smem = sizeof(float) * (2 * DQ_ROWS * D + 2 * BWD_BK * (D + 1) +
                                       DQ_ROWS * BWD_BK + 2 * DQ_ROWS);
  auto kern = bwd_dq_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + block_q - 1) / block_q, KV, B);
  kern<<<grid, BWD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dq), static_cast<const int*>(q_off), Sq, Sk, H, KV, block_q, win, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* di, void* dk, void* dv, const void* q_off,
                           int B, int Sq, int Sk, int H, int KV, int win, float sm_scale,
                           cudaStream_t stream) {
  const int block_q = DKV_ROWS / (H / KV);
  const size_t smem = sizeof(float) * (2 * BWD_BK * (D + 1) + 2 * DKV_ROWS * D +
                                       2 * DKV_ROWS * BWD_BK + 2 * DKV_ROWS);
  auto kern = bwd_dkv_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sk + BWD_BK - 1) / BWD_BK, KV, B);
  kern<<<grid, BWD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<const int*>(q_off), Sq, Sk, H, KV,
      block_q, win, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_by_dtype(int dtype, bool dq_pass, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* di, void* o1, void* o2,
                         const void* q_off, int B, int Sq, int Sk, int H, int KV, int win,
                         float sm_scale, cudaStream_t s) {
#define BWD_CASE(T)                                                                        \
  return dq_pass ? launch_bwd_dq<T, D>(q, k, v, dout, lse, di, o1, q_off, B, Sq, Sk, H, KV, \
                                       win, sm_scale, s)                                    \
                 : launch_bwd_dkv<T, D>(q, k, v, dout, lse, di, o1, o2, q_off, B, Sq, Sk, H, \
                                        KV, win, sm_scale, s)
  switch (dtype) {
    case 0: BWD_CASE(float);
    case 1: BWD_CASE(__nv_bfloat16);
    case 2: BWD_CASE(__half);
  }
#undef BWD_CASE
  return cudaErrorInvalidValue;
}

int bwd_entry(bool dq_pass, const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* di, void* o1, void* o2, const void* q_off, int B,
              int Sq, int Sk, int H, int KV, int D, int dtype, int window, float sm_scale,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || H / KV > DQ_ROWS || B <= 0 || Sq <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  if (D == 32) return bwd_by_dtype<32>(dtype, dq_pass, q, k, v, dout, lse, di, o1, o2, q_off, B, Sq, Sk, H, KV, window, sm_scale, s);
  if (D == 64) return bwd_by_dtype<64>(dtype, dq_pass, q, k, v, dout, lse, di, o1, o2, q_off, B, Sq, Sk, H, KV, window, sm_scale, s);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t fwd_by_dtype(int dtype, const void* q, const void* k, const void* v, void* out,
                         void* lse, const void* q_off, int B, int Sq, int Sk, int H, int KV,
                         int win, float sm_scale, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_fwd<float, D>(q, k, v, out, lse, q_off, B, Sq, Sk, H, KV, win, sm_scale, s);
    case 1: return launch_fwd<__nv_bfloat16, D>(q, k, v, out, lse, q_off, B, Sq, Sk, H, KV, win, sm_scale, s);
    case 2: return launch_fwd<__half, D>(q, k, v, out, lse, q_off, B, Sq, Sk, H, KV, win, sm_scale, s);
  }
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t decode_by_dtype(int dtype, const void* q, const void* k, const void* v,
                            const void* tables, const void* pos, void* m, void* l, void* acc,
                            int B, int H, int KV, int S, int NP, int block_k, int ns, int kv_len,
                            int win, float sm_scale, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_decode<float, D>(q, k, v, tables, pos, m, l, acc, B, H, KV, S, NP, block_k, ns, kv_len, win, sm_scale, s);
    case 1: return launch_decode<__nv_bfloat16, D>(q, k, v, tables, pos, m, l, acc, B, H, KV, S, NP, block_k, ns, kv_len, win, sm_scale, s);
    case 2: return launch_decode<__half, D>(q, k, v, tables, pos, m, l, acc, B, H, KV, S, NP, block_k, ns, kv_len, win, sm_scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k/v (B, Sk, KV, D), q_off (B,) int32 on the device;
// out (B, Sq, H, D) in the input dtype, lse (B, Sq, H) fp32 or NULL.
// dtype: 0 float32, 1 bfloat16, 2 float16. D: 32 or 64. G = H/KV <= 16: a block
// holds (16 / G) queries of G heads each, the spare rows idle.
int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
              const void* q_off, int B, int Sq, int Sk, int H, int KV, int D, int dtype,
              int window, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || H / KV > FWD_ROWS) return cudaErrorInvalidValue;
  if (D == 32) return fwd_by_dtype<32>(dtype, q, k, v, out, lse, q_off, B, Sq, Sk, H, KV, window, sm_scale, s);
  if (D == 64) return fwd_by_dtype<64>(dtype, q, k, v, out, lse, q_off, B, Sq, Sk, H, KV, window, sm_scale, s);
  return cudaErrorInvalidValue;
}

// Backward of flash_fwd. q/dout (B, Sq, H, D), k/v (B, Sk, KV, D) in one
// dtype; lse and di = rowsum(out * dout) (B, Sq, H) fp32; q_off (B,) int32.
// dq (B, Sq, H, D); dk/dv (B, Sk, KV, D), summed over the G heads of a group.
// G = H/KV <= 16, rows of a q tile = (16 / G) * G (dq) and (32 / G) * G (dk/dv).
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* di, void* dq, const void* q_off, int B, int Sq, int Sk, int H,
                 int KV, int D, int dtype, int window, float sm_scale, void* stream) {
  return bwd_entry(true, q, k, v, dout, lse, di, dq, nullptr, q_off, B, Sq, Sk, H, KV, D, dtype,
                   window, sm_scale, stream);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* di, void* dk, void* dv, const void* q_off, int B,
                  int Sq, int Sk, int H, int KV, int D, int dtype, int window, float sm_scale,
                  void* stream) {
  return bwd_entry(false, q, k, v, dout, lse, di, dk, dv, q_off, B, Sq, Sk, H, KV, D, dtype,
                   window, sm_scale, stream);
}

// q (B, 1, H, D); contiguous: k/v (B, S, KV, D), tables NULL, NP 0;
// paged: k/v (P, block_k, KV, D), tables (B, NP) int32, S unused.
// pos (B,) int32. Partials m/l (B, KV, ns, G) and acc (B, KV, ns, G, D) fp32.
int flash_decode_split(const void* q, const void* k, const void* v, const void* tables,
                       const void* pos, void* m, void* l, void* acc, int B, int H, int KV,
                       int D, int dtype, int S, int NP, int block_k, int ns, int kv_len,
                       int window, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || H / KV > DEC_MAX_G || block_k <= 0) return cudaErrorInvalidValue;
  if (D == 32) return decode_by_dtype<32>(dtype, q, k, v, tables, pos, m, l, acc, B, H, KV, S, NP, block_k, ns, kv_len, window, sm_scale, s);
  if (D == 64) return decode_by_dtype<64>(dtype, q, k, v, tables, pos, m, l, acc, B, H, KV, S, NP, block_k, ns, kv_len, window, sm_scale, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
