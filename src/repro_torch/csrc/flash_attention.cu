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
//   flash_decode_combine <- the same file's _combine_kv_splits (plain jnp
//                         outside the pallas_call there)
//   flash_mla_fwd, flash_mla_bwd_dq, flash_mla_bwd_dkv <- _fwd_kernel,
//                         _dq_kernel and _dkv_kernel in the MLA absorbed
//                         layout (Dk 576, Dv 512, one KV head) that
//                         src/repro/models/attention.py:mla_forward calls;
//                         flash_mla_dkv_reduce the sum _dkv_kernel carries
//                         across q tiles in its scratch (bf16/fp16 dk/dv)
//
// What bounds them on an H100: the forward and the backward at the
// training shapes (B 4, S 1024, 32 heads over 8, D 64) are bound by
// operations -- 4D (forward), 6D (dq) and 8D (dk/dv) FLOPs per live (row,
// key) pair against ~4 bytes of input per row and key column, far above
// the ~295 FLOP/byte where bf16 tensor cores become the limit. So in bf16
// and fp16 they run on the tensor cores (the "Hopper" kernels: wgmma
// products with fp32 accumulators in registers, operand tiles brought into
// shared memory by TMA, swizzled as wgmma reads them); in fp32 on the CUDA
// cores, whose 1e-5 checks TF32 products could not meet. The one-token
// decode is bound by reading K/V from device memory (2*G score FLOPs per
// key byte): it reads each visible K/V row once per (kv head, chunk)
// block, folds the G query heads of a KV group into the rows of one block
// (as the TPU kernel folds them into its q tile), and never writes a score
// matrix to device memory; its products are fp32 FMAs in registers on
// 16-byte loads (see decode_kernel).
//
// Head dims: 32, 64 and 128 everywhere at Dk == Dv (the CUDA-core kernels
// hold D / 32 columns a lane; the tensor-core kernels take a D-128 row as
// two 64-value panels, see Tile); the Python wrappers zero-pad any other
// head dim up to 128 to the next of them. The MLA absorbed layout (Dk !=
// Dv, KV = 1) and head dims above 128 take the MLA route (flash_mla_*):
// the CUDA-core forward, dq and dk/dv in fp32, built at (Dk, Dv) = (96,
// 64) and (576, 512), others zero-padded up to one of them; in bf16/fp16
// the forward, dq and dk/dv on the tensor cores (fwd_mla_hopper,
// bwd_dq_mla_hopper, bwd_dkv_mla_hopper + mla_dkv_reduce), built at (576,
// 512) alone, every pair zero-padded up to it. GQA group size G = H / KV:
// up to 64 on the D <= 128 tensor-core kernels (a 64-row tile holds 64 / G
// queries), up to 16 on the CUDA-core kernels, the MLA route and the
// decode.
//
// Numerics follow the TPU kernels: fp32 online softmax, NEG_INF = -1e30,
// masked p zeroed explicitly, l clamped at 1e-30, and p rounded to the
// value dtype before the PV product.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
// The CUDA-core kernels: the forward, dq and dk/dv on fp32 FMAs, for any
// input type T (fp32, bf16, fp16; fp32 arithmetic) and any pair of head
// dims DK (q, k) and DV (v, do, out) that are multiples of 32. They take
// two routes:
//
// - fp32 at DK = DV in {32, 64, 128}: the bf16/fp16 inputs of those dims
//   take the tensor-core kernels below (fwd_hopper, bwd_*_hopper);
// - the MLA absorbed layout and every head dim above 128 (mla_entry): DK
//   != DV or DK > 128, in fp32 (bf16/fp16 take fwd_mla_hopper,
//   bwd_dq_mla_hopper and bwd_dkv_mla_hopper below).
//   DeepSeek-V2's absorbed attention is one KV head (the 512-value latent
//   plus the 64-value rope key, DK 576) whose values are the latent alone
//   (DV 512), under G = 16 query heads
//   (src/repro/kernels/flash_attention.py:10-15, the _fwd_kernel,
//   _dq_kernel and _dkv_kernel at Dk != Dv). Built at (576, 512) and (96,
//   64); the wrapper zero-pads any other pair up to (576, 512) to the
//   smallest built pair that holds it (exact, as pad_head_dim).
//
// What bounds them at the MLA shape (B 2, S 1024, 16 heads over 1, DK 576,
// DV 512): operations -- 2 (DK + DV) FLOPs a live (row, key) pair in the
// forward, 2 (2 DK + DV) in dq, 4 (DK + DV) in dk/dv, against a few bytes
// of input a row and key; on the CUDA cores that is 67 TFLOP/s of fp32
// at best, 15x under the tensor cores' bf16 rate. These kernels are the
// simple, right version: shared memory holds fp32 copies of the q rows and
// the K/V tile (the whole DK and DV width, so one block computes complete
// scores), each lane owns one key of the 32-key tile for the scores and
// DV / 32 (or DK / 32) output columns for the products, and the score
// loops read q and k as float4 (k rows padded to DK + 4 floats: a
// quarter-warp's 16-byte loads hit distinct banks) while summing in the
// order d = 0, 1, ..., as a scalar loop would. At (576, 512) a block's
// shared memory is 175 KB (forward), 207 KB (dq) and 209 KB (dk/dv), so
// one block an SM; dk/dv there runs 8 warps of 4 keys each (4 x (18 + 16)
// fp32 accumulators a lane) over q tiles of 16 rows, where the fp32 head
// dims keep 4 warps of 8 keys over 32 rows. No atomics: dk/dv are summed
// over the G heads and all q tiles in one block's registers, so two calls
// agree bit for bit. On the MLA route these run fp32 alone, the path of
// the finite-difference and equivalence checks; bf16/fp16 training there
// runs fwd_mla_hopper and bwd_*_mla_hopper.
// ---------------------------------------------------------------------------

constexpr int FWD_THREADS = 128;           // 4 warps
constexpr int FWD_WARPS = FWD_THREADS / 32;
// Row capacity of a block: block_q = FWD_ROWS / G queries of G heads each,
// block_q * G rows; where G does not divide FWD_ROWS (G = 3: 15 rows) the
// spare rows stay idle. Small on purpose: the forward runs one FMA chain a
// lane per row, so more blocks keep more of the SMs busy.
constexpr int FWD_ROWS = 16;
constexpr int FWD_RPW = FWD_ROWS / FWD_WARPS;
constexpr int FWD_BK = 32;                 // keys per tile: one per lane
constexpr int KPAD = 4;                    // k/v row padding (floats)

// The largest G = H / KV of the CUDA-core kernels (and of the MLA route).
constexpr int CC_MAX_G = 16;

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

// keys [j*32, (j+1)*32) of kv head h of a (B, Sk, KV, D) tensor as fp32
// rows of D + KPAD floats (zeros past Sk)
template <typename T, int D>
__device__ __forceinline__ void load_keys(float* dst, const T* __restrict__ src, int b, int j,
                                          int Sk, int KV, int h) {
  for (int e = threadIdx.x; e < FWD_BK * D; e += blockDim.x) {
    const int c = e / D, d = e % D;
    const int kpos = j * FWD_BK + c;
    dst[c * (D + KPAD) + d] =
        kpos < Sk ? to_f<T>(src[(((size_t)b * Sk + kpos) * KV + h) * D + d]) : 0.f;
  }
}

// s[t] += q[r_t] . k[lane] over D columns, in the order d = 0, 1, ...:
// q rows of D floats (broadcast reads), the lane's k row of D + KPAD
template <int D, int N>
__device__ __forceinline__ void row_dots(float (&s)[N], const float* __restrict__ qs,
                                         const int (&r)[N], const float* __restrict__ krow) {
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 kd = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const float4 qd = *reinterpret_cast<const float4*>(qs + r[t] * D + d);
      s[t] += qd.x * kd.x;
      s[t] += qd.y * kd.y;
      s[t] += qd.z * kd.z;
      s[t] += qd.w * kd.w;
    }
  }
}

// one block per (q tile, kv head, batch row)
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(FWD_THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ out, float* __restrict__ lse, const int* __restrict__ q_off,
           int Sq, int Sk, int H, int KV, int block_q, int win, float sm_scale) {
  constexpr int DPL = DV / 32;  // output columns per lane
  const int G = H / KV;
  const int rows = block_q * G;
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qoff = q_off[b];

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [FWD_ROWS][DK]
  float* ks = qs + FWD_ROWS * DK;          // [FWD_BK][DK + KPAD]
  float* vs = ks + FWD_BK * (DK + KPAD);   // [FWD_BK][DV]
  float* ps = vs + FWD_BK * DV;            // [FWD_ROWS][FWD_BK]

  // row r of the tile is (query i*block_q + r/G, head h*G + r%G): the G
  // heads of a query are adjacent in the (B, Sq, H, D) layout
  load_rows<T, DK, FWD_ROWS>(qs, q, b, i, Sq, H, h, G, block_q);

  int rr[FWD_RPW];
  float m[FWD_RPW], l[FWD_RPW], acc[FWD_RPW][DPL];
#pragma unroll
  for (int t = 0; t < FWD_RPW; ++t) {
    rr[t] = warp + FWD_WARPS * t;
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
    load_keys<T, DK>(ks, k, b, j, Sk, KV, h);
    for (int e = threadIdx.x; e < FWD_BK * DV; e += FWD_THREADS) {
      const int c = e / DV, d = e % DV;
      const int kpos = j * FWD_BK + c;
      vs[e] = kpos < Sk ? to_f<T>(v[(((size_t)b * Sk + kpos) * KV + h) * DV + d]) : 0.f;
    }
    __syncthreads();

    float s[FWD_RPW];
#pragma unroll
    for (int t = 0; t < FWD_RPW; ++t) s[t] = 0.f;
    row_dots<DK>(s, qs, rr, ks + lane * (DK + KPAD));
    const int kpos = j * FWD_BK + lane;
#pragma unroll
    for (int t = 0; t < FWD_RPW; ++t) {
      const int r = rr[t];
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
      ps[r * FWD_BK + lane] = round_to<T>(p);   // p.astype(v.dtype)
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[t][dd] *= alpha;
    }
    __syncwarp();
    for (int c = 0; c < FWD_BK; ++c) {
      float vv[DPL];
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) vv[dd] = vs[c * DV + lane + 32 * dd];
#pragma unroll
      for (int t = 0; t < FWD_RPW; ++t) {
        const float pc = ps[rr[t] * FWD_BK + c];
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[t][dd] += pc * vv[dd];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int t = 0; t < FWD_RPW; ++t) {
    const int r = rr[t];
    const int qi = i * block_q + r / G;
    if (r >= rows || qi >= Sq) continue;
    const size_t row = ((size_t)b * Sq + qi) * H + h * G + r % G;
    const float lc = fmaxf(l[t], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) out[row * DV + lane + 32 * dd] = from_f<T>(acc[t][dd] / lc);
    if (lse != nullptr && lane == 0) lse[row] = m[t] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// backward: dq, and dk/dv summed over the G heads of a group
// ---------------------------------------------------------------------------
//
// Both recompute p = exp(s * sm_scale - lse) per tile from the saved fp32
// lse (never stored), with ds = p * (dp - di) * sm_scale, dp = do . v and
// di = rowsum(out * do) (over DV) computed by the caller. Casts follow the
// TPU kernels: ds to k's dtype before ds @ k (dq), p to do's dtype and ds
// to q's dtype before the dv / dk contractions.
//
// What bounds them at the LM training shapes (B 4, S 1024, 32 heads over
// 8, D 64): operations -- 6D (dq) and 8D (dk/dv) FLOPs per live (row, key)
// pair against ~4 bytes of input per row and key column, far above the
// ~295 FLOP/byte where bf16 tensor cores become the limit. So bf16/fp16 at
// D <= 128 run on the tensor cores (the "Hopper" kernels below): wgmma
// products with fp32 accumulators in registers, operand tiles brought into
// shared memory by TMA, swizzled as wgmma reads them.
//
// fp32 stays on the CUDA cores (bwd_dq_kernel / bwd_dkv_kernel<float>),
// at D <= 128 and on the MLA route alike: its check is 1e-5 of the
// output's scale, which TF32 products (10-bit mantissa) cannot meet, and
// fp32 is the path of the finite-difference and equivalence checks, not
// of training. bf16/fp16 on the MLA route take the tensor-core
// bwd_dq_mla_hopper / bwd_dkv_mla_hopper (see their note). bwd_by_dtype
// and mla_launch dispatch explicitly by (dtype, head dims); nothing falls
// back from one path to the other.

constexpr int BWD_BK = FWD_BK;             // keys per tile: one per lane
// dq: 4 warps, one block per (q tile, kv head, batch row), rows =
// (DQ_ROWS / G) * G
constexpr int DQ_THREADS = 128;
constexpr int DQ_WARPS = DQ_THREADS / 32;
constexpr int DQ_ROWS = 16;
constexpr int DQ_RPW = DQ_ROWS / DQ_WARPS;

// dk/dv: one block per (key tile, kv head, batch row) walking q tiles of
// (ROWS / G) * G rows; each of the WARPS warps owns 32 / WARPS keys of the
// tile, so dk/dv are summed over the whole group in registers, no atomics.
// (ROWS, WARPS) = (32, 4) up to DK + DV = 256, (16, 8) above: 4 keys a
// warp keep (DK + DV) / 8 accumulators a lane (136 at (576, 512)).
template <int DK, int DV> struct DkvShape {
  static constexpr bool WIDE = DK + DV > 256;
  static constexpr int ROWS = WIDE ? 16 : 32;
  static constexpr int WARPS = WIDE ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int RPW = ROWS / WARPS;
  static constexpr int KPW = BWD_BK / WARPS;
};

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(DQ_THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ di, T* __restrict__ dq, const int* __restrict__ q_off,
              int Sq, int Sk, int H, int KV, int block_q, int win, float sm_scale) {
  constexpr int DPL = DK / 32;
  const int G = H / KV;
  const int rows = block_q * G;
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int first_q = q_off[b] + i * block_q;   // oldest query of the tile

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [DQ_ROWS][DK]
  float* dos = qs + DQ_ROWS * DK;          // [DQ_ROWS][DV]
  float* ks = dos + DQ_ROWS * DV;          // [BWD_BK][DK + KPAD]
  float* vs = ks + BWD_BK * (DK + KPAD);   // [BWD_BK][DV + KPAD]
  float* dss = vs + BWD_BK * (DV + KPAD);  // [DQ_ROWS][BWD_BK]
  float* lses = dss + DQ_ROWS * BWD_BK;    // [DQ_ROWS]
  float* dis = lses + DQ_ROWS;             // [DQ_ROWS]

  load_rows<T, DK, DQ_ROWS>(qs, q, b, i, Sq, H, h, G, block_q);
  load_rows<T, DV, DQ_ROWS>(dos, dout, b, i, Sq, H, h, G, block_q);
  load_row_stats<DQ_ROWS>(lses, lse, b, i, Sq, H, h, G, block_q);
  load_row_stats<DQ_ROWS>(dis, di, b, i, Sq, H, h, G, block_q);

  int rr[DQ_RPW];
  float acc[DQ_RPW][DPL];
#pragma unroll
  for (int t = 0; t < DQ_RPW; ++t) {
    rr[t] = warp + DQ_WARPS * t;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[t][dd] = 0.f;
  }

  const int nk = (Sk + BWD_BK - 1) / BWD_BK;
  const int j_hi = min(nk - 1, (first_q + block_q - 1) / BWD_BK);  // causal tile skip
  for (int j = 0; j <= j_hi; ++j) {
    // window tile skip (_tile_live); uniform over the block
    if (win > 0 && (j + 1) * BWD_BK <= first_q - win + 1) continue;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_keys<T, DK>(ks, k, b, j, Sk, KV, h);
    load_keys<T, DV>(vs, v, b, j, Sk, KV, h);
    __syncthreads();

    // s = q . k and dp = do . v: lane = key, warp = rows warp + 4t
    float s[DQ_RPW], dp[DQ_RPW];
#pragma unroll
    for (int t = 0; t < DQ_RPW; ++t) s[t] = dp[t] = 0.f;
    row_dots<DK>(s, qs, rr, ks + lane * (DK + KPAD));
    row_dots<DV>(dp, dos, rr, vs + lane * (DV + KPAD));
    const int kpos = j * BWD_BK + lane;
#pragma unroll
    for (int t = 0; t < DQ_RPW; ++t) {
      const int r = rr[t];
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
      for (int dd = 0; dd < DPL; ++dd) kk[dd] = ks[c * (DK + KPAD) + lane + 32 * dd];
#pragma unroll
      for (int t = 0; t < DQ_RPW; ++t) {
        const float dsc = dss[rr[t] * BWD_BK + c];
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[t][dd] += dsc * kk[dd];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int t = 0; t < DQ_RPW; ++t) {
    const int r = rr[t];
    const int qi = i * block_q + r / G;
    if (r >= rows || qi >= Sq) continue;
    const size_t row = ((size_t)b * Sq + qi) * H + h * G + r % G;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) dq[row * DK + lane + 32 * dd] = from_f<T>(acc[t][dd]);
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(DkvShape<DK, DV>::THREADS)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
               const int* __restrict__ q_off, int Sq, int Sk, int H, int KV, int block_q,
               int win, float sm_scale) {
  using Sh = DkvShape<DK, DV>;
  constexpr int ROWS = Sh::ROWS, WARPS = Sh::WARPS, RPW = Sh::RPW, KPW = Sh::KPW;
  constexpr int KPL = DK / 32, VPL = DV / 32;   // dk / dv columns per lane
  const int G = H / KV;
  const int rows = block_q * G;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qoff = q_off[b];

  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                        // [BWD_BK][DK + KPAD]
  float* vs = ks + BWD_BK * (DK + KPAD);   // [BWD_BK][DV + KPAD]
  float* qs = vs + BWD_BK * (DV + KPAD);   // [ROWS][DK]
  float* dos = qs + ROWS * DK;             // [ROWS][DV]
  float* ps = dos + ROWS * DV;             // [ROWS][BWD_BK]
  float* dss = ps + ROWS * BWD_BK;         // [ROWS][BWD_BK]
  float* lses = dss + ROWS * BWD_BK;       // [ROWS]
  float* dis = lses + ROWS;                // [ROWS]

  load_keys<T, DK>(ks, k, b, j, Sk, KV, h);
  load_keys<T, DV>(vs, v, b, j, Sk, KV, h);

  int rr[RPW];
#pragma unroll
  for (int t = 0; t < RPW; ++t) rr[t] = warp + WARPS * t;
  float acc_k[KPW][KPL], acc_v[KPW][VPL];
#pragma unroll
  for (int u = 0; u < KPW; ++u) {
#pragma unroll
    for (int dd = 0; dd < KPL; ++dd) acc_k[u][dd] = 0.f;
#pragma unroll
    for (int dd = 0; dd < VPL; ++dd) acc_v[u][dd] = 0.f;
  }

  const int nq = (Sq + block_q - 1) / block_q;
  const int kpos = j * BWD_BK + lane;
  for (int i = 0; i < nq; ++i) {
    const int first_q = qoff + i * block_q;
    // _tile_live: not above the causal diagonal, not older than the window
    if (j * BWD_BK > first_q + block_q - 1) continue;
    if (win > 0 && (j + 1) * BWD_BK <= first_q - win + 1) continue;
    __syncthreads();  // every warp is done with the previous q tile
    load_rows<T, DK, ROWS>(qs, q, b, i, Sq, H, h, G, block_q);
    load_rows<T, DV, ROWS>(dos, dout, b, i, Sq, H, h, G, block_q);
    load_row_stats<ROWS>(lses, lse, b, i, Sq, H, h, G, block_q);
    load_row_stats<ROWS>(dis, di, b, i, Sq, H, h, G, block_q);
    __syncthreads();

    // s = q . k and dp = do . v: lane = key, warp = rows warp + WARPS t
    float s[RPW], dp[RPW];
#pragma unroll
    for (int t = 0; t < RPW; ++t) s[t] = dp[t] = 0.f;
    row_dots<DK>(s, qs, rr, ks + lane * (DK + KPAD));
    row_dots<DV>(dp, dos, rr, vs + lane * (DV + KPAD));
#pragma unroll
    for (int t = 0; t < RPW; ++t) {
      const int r = rr[t];
      const int qpos = first_q + r / G;
      const bool keep = r < rows && i * block_q + r / G < Sq && kpos <= qpos && kpos < Sk &&
                        window_keep(qpos, kpos, win);
      const float p = keep ? expf(s[t] * sm_scale - lses[r]) : 0.f;
      ps[r * BWD_BK + lane] = round_to<T>(p);
      dss[r * BWD_BK + lane] = round_to<T>(p * (dp[t] - dis[r]) * sm_scale);
    }
    __syncthreads();  // the contractions read every warp's rows

    // dv[c][d] += sum_r p[r][c] do[r][d], then dk[c][d] += sum_r ds[r][c]
    // q[r][d]: warp = keys c = warp * KPW + u, lane = column d
    for (int r = 0; r < rows; ++r) {
      float dov[VPL];
#pragma unroll
      for (int dd = 0; dd < VPL; ++dd) dov[dd] = dos[r * DV + lane + 32 * dd];
#pragma unroll
      for (int u = 0; u < KPW; ++u) {
        const float pc = ps[r * BWD_BK + warp * KPW + u];
#pragma unroll
        for (int dd = 0; dd < VPL; ++dd) acc_v[u][dd] += pc * dov[dd];
      }
    }
    for (int r = 0; r < rows; ++r) {
      float qv[KPL];
#pragma unroll
      for (int dd = 0; dd < KPL; ++dd) qv[dd] = qs[r * DK + lane + 32 * dd];
#pragma unroll
      for (int u = 0; u < KPW; ++u) {
        const float dsc = dss[r * BWD_BK + warp * KPW + u];
#pragma unroll
        for (int dd = 0; dd < KPL; ++dd) acc_k[u][dd] += dsc * qv[dd];
      }
    }
  }

#pragma unroll
  for (int u = 0; u < KPW; ++u) {
    const int kp = j * BWD_BK + warp * KPW + u;
    if (kp >= Sk) continue;
    const size_t row = ((size_t)b * Sk + kp) * KV + h;
#pragma unroll
    for (int dd = 0; dd < KPL; ++dd) dk[row * DK + lane + 32 * dd] = from_f<T>(acc_k[u][dd]);
#pragma unroll
    for (int dd = 0; dd < VPL; ++dd) dv[row * DV + lane + 32 * dd] = from_f<T>(acc_v[u][dd]);
  }
}

// ---------------------------------------------------------------------------
// backward on Hopper's tensor cores (bf16 / fp16)
// ---------------------------------------------------------------------------
//
// One warpgroup (128 threads) a block; every product is a wgmma of 64 rows.
// dq: a block owns one q tile of HB_M = 64 rows ((64 / G) queries x their
// G heads; the spare rows of G = 3, 5, ... stay zero and are not stored)
// with Q and dO resident in shared memory, and walks its live key tiles of
// 64 keys: S = Q K^T and dP = dO V^T from shared memory, P and dS in
// registers, dQ += dS K with dS as the register A operand and K read
// transposed (its keys are the contraction). dk/dv: a block owns 64 keys
// of one kv head with K and V resident and walks the live q tiles in
// transposed form, so that keys are the M side: S^T = K Q^T, dP^T = V
// dO^T, then dV += P^T dO and dK += dS^T Q with the accumulators reused as
// register A operands. dk/dv are summed over the G heads and all q tiles
// in the block's registers: no atomics, one summation order, so two calls
// agree bit for bit.
//
// Tiles arrive by TMA: K/V tiles (dq) and Q/dO tiles (dk/dv) stream
// through a ring of 2 stages completed on mbarriers, the next tile in
// flight while the current one is computed. A q tile of the (B, S, H, D)
// tensor is the [queries][G][D] box of a 4-D view (D, H, S, B), so the
// rows past S are zero-filled per batch row; a key tile the [64][1][D] box
// of (D, KV, S, B); each in the panels of Tile<D>, swizzled as the wgmma
// descriptors (desc_k, desc_t) name them. lse and di of a q tile
// (G fp32 values a query: under TMA's 16-byte box minimum when G < 4) come
// by cp.async into the same 2-stage ring.
//
// Causal balance: a flat grid ordered heaviest first -- dk/dv's key tile 0
// (which every query sees) for all (kv head, batch) pairs, then tile 1,
// ...; dq's q tiles from the last (most live key tiles) down. Tiles above
// the diagonal or outside the window are skipped (_tile_live); the
// element mask runs only on tiles that cross the diagonal, the window edge
// or a ragged end. p = 2^(s * sm_scale * log2 e - lse * log2 e).

constexpr int HB_THREADS = 128;   // one warpgroup
constexpr int HB_M = 64;          // rows of a q tile = keys of a key tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// A wait that outlives ~10 s of clock (a TMA that never lands) traps, so a
// fault shows as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > 20000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// the box at (c0, c1, c2, c3) of a 4-D tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// 4 bytes, zero-filled where src_bytes == 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from reading accumulators before the wgmma wait
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Tile geometry at head dim D. A 64-row tile of 16-bit values lands in
// shared memory as PANELS panels of [64][PCOLS], each written by one TMA
// box: one panel at D 32 and 64, two of 64 columns at D 128 (a 128-byte
// swizzle atom is 64 values wide, and a box with that swizzle may be at
// most 128 bytes wide). Rows of 128 bytes take TMA's 128-byte swizzle, the
// 64-byte rows of D 32 the 64-byte one.
template <int D> struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  static constexpr int PCOLS = D < 64 ? D : 64;   // values in a panel row
  static constexpr int ROWB = PCOLS * 2;          // bytes in a panel row
  static constexpr int PANEL = HB_M * ROWB;       // bytes of a panel
  static constexpr int PANELS = D / PCOLS;
  static constexpr int BYTES = HB_M * D * 2;      // bytes of the tile
};

// wgmma shared-memory descriptor: start address, leading byte offset,
// stride byte offset (8 rows of a panel) and the swizzle TMA wrote.
template <int D> __device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo) {
  constexpr uint64_t layout = Tile<D>::ROWB == 128 ? 1 : 2;  // SWIZZLE_128B : SWIZZLE_64B
  constexpr uint64_t sbo = 8 * Tile<D>::ROWB;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((sbo >> 4) << 32) |
         (layout << 62);
}

// A K-major operand (rows = M or N, D the contraction): k-step kk (16
// values of D) lies in panel 16 kk / PCOLS, 32 bytes a step along its rows.
// A step never leaves its swizzle atom, so the leading offset is unused.
template <int D> __device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using TL = Tile<D>;
  return gmma_desc<D>(tile + (kk * 16 / TL::PCOLS) * TL::PANEL + (kk * 16 % TL::PCOLS) * 2, 16);
}

// A transposed B operand (rows = the contraction, D = N): k-step kk is rows
// 16 kk .. 16 kk + 15 of each panel. At D 128, N spans two 64-value atoms,
// one a panel: the leading offset is the panel stride (unused at D 32/64).
template <int D> __device__ __forceinline__ uint64_t desc_t(uint32_t tile, int kk) {
  using TL = Tile<D>;
  return gmma_desc<D>(tile + kk * 16 * TL::ROWB, TL::PANELS > 1 ? TL::PANEL : 16);
}

// the panels of a tile by TMA: box (PCOLS, n, s, 1) at (PCOLS p, c1, c2, c3)
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c1, int c2, int c3) {
#pragma unroll
  for (int p = 0; p < Tile<D>::PANELS; ++p)
    tma_load(dst + p * Tile<D>::PANEL, map, bar, p * Tile<D>::PCOLS, c1, c2, c3);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma products, for T = bf16 ("bf16") and fp16 ("f16"), accumulating
// into fp32 registers d (the last argument picks T):
//   wgmma_ss_n64: m64n64k16, A and B from shared memory, both K-major:
//                 d += A B^T
//   wgmma_ss_n16: the same at m64n16k16
//   wgmma_ss_tb:  m64n64k16, A K-major and B transposed (N contiguous),
//                 both from shared memory: d += A B
//   wgmma_rs_tb:  m64n{32,64,128}k16, A from registers, B from shared memory
//                 transposed (N contiguous): d += A B
#define WG_ACC16                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                                       \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                                       \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                                     \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WG_ACC32                                                                        \
  WG_ACC16,                                                                             \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                                   \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                                   \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                                   \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WG_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_REGS32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_ACC64                                                                        \
  WG_ACC32,                                                                             \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                                   \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                                   \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                                   \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                                   \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                                   \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                                   \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                                   \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define WG_REGS64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WGMMA_FUNCS(CT, TY)                                                             \
  __device__ __forceinline__ void wgmma_ss_n64(float(&d)[32], uint64_t da, uint64_t db, \
                                               CT) {                                    \
    asm volatile("wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " WG_REGS32 \
                 ", %32, %33, 1, 1, 1, 0, 0;\n"                                         \
                 : WG_ACC32                                                             \
                 : "l"(da), "l"(db));                                                   \
  }                                                                                     \
  __device__ __forceinline__ void wgmma_ss_n16(float(&d)[8], uint64_t da, uint64_t db,  \
                                               CT) {                                    \
    asm volatile("wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY               \
                 " {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, 1, 1, 1, 0, 0;\n"          \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                      \
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                       \
                 : "l"(da), "l"(db));                                                   \
  }                                                                                     \
  __device__ __forceinline__ void wgmma_ss_tb(float(&d)[32], uint64_t da, uint64_t db,  \
                                              CT) {                                     \
    asm volatile("wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " WG_REGS32 \
                 ", %32, %33, 1, 1, 1, 0, 1;\n"                                         \
                 : WG_ACC32                                                             \
                 : "l"(da), "l"(db));                                                   \
  }                                                                                     \
  __device__ __forceinline__ void wgmma_rs_tb(float(&d)[16], const uint32_t(&a)[4],    \
                                              uint64_t db, CT) {                        \
    asm volatile("wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " WG_REGS16 \
                 ", {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"                           \
                 : WG_ACC16                                                             \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));                \
  }                                                                                     \
  __device__ __forceinline__ void wgmma_rs_tb(float(&d)[32], const uint32_t(&a)[4],    \
                                              uint64_t db, CT) {                        \
    asm volatile("wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " WG_REGS32 \
                 ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"                           \
                 : WG_ACC32                                                             \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));                \
  }                                                                                     \
  __device__ __forceinline__ void wgmma_rs_tb(float(&d)[64], const uint32_t(&a)[4],    \
                                              uint64_t db, CT) {                        \
    asm volatile("wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " WG_REGS64 \
                 ", {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"                          \
                 : WG_ACC64                                                             \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));                \
  }
WGMMA_FUNCS(__nv_bfloat16, "bf16")
WGMMA_FUNCS(__half, "f16")
#undef WGMMA_FUNCS

template <int N> __device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// Accumulator element c of a 64-row wgmma tile, for thread (warp w, lane):
// row 16w + lane/4 + 8 * ((c >> 1) & 1), column 8 * (c >> 2) + 2 * (lane & 3)
// + (c & 1). Elements c, c + 1 of the same row pack into A-operand register
// (c >> 1) & 3 of k-step c >> 3 (16 columns a step).

// ---------------------------------------------------------------------------
// forward on Hopper's tensor cores (bf16 / fp16)
// ---------------------------------------------------------------------------
//
// One warpgroup a block owns a q tile of HB_M = 64 rows ((64 / G) queries x
// their G heads, the [64/G][G][D] box of the backward; the spare rows of G
// not dividing 64 stay zero and are not stored) with Q resident in shared
// memory, and walks its live key tiles of 64 keys, K and V streaming by TMA
// through a ring of FWD_STAGES stages on mbarriers. S = Q K^T is a wgmma
// from shared memory into fp32 registers; the online softmax runs on those
// registers (exp2, log2 e folded into the scale; a row's maximum across
// the 4 lanes that hold it); P, rounded to the value dtype, is used in
// place as the register A operand of O += P V, with V read transposed (its
// keys are the contraction), the fragment identity the backward uses for
// dS. l sums the unrounded p, per thread until the end.
//
// Masking and order: tiles above the diagonal or older than the window are
// never loaded (_tile_live); the element mask runs only on tiles that
// cross the diagonal, the window edge or a ragged end of the keys. The
// flat grid takes the last q tiles of every (kv head, batch) pair first:
// they see the most keys.
//
// What hides the latency of a tile's steps (wgmma, wait, softmax, wgmma,
// wait) is other blocks on the same SM, so the design keeps a block small:
// one warpgroup, two K/V stages (40 KB of shared memory at D 64, 80 KB at
// D 128), 74-127 registers, so five blocks share an SM at D 64 and two at
// D 128. A third stage (fewer blocks an SM), two consumer warpgroups
// sharing each K/V tile (in lockstep at every tile), and issuing the next
// tile's S before this tile's softmax (more registers) were each slower on
// an H100 at the training shapes and the serve chunk.
//
// The serve path's prefill chunk (32 queries of 32 heads over 8, one 1 K
// lane) gives 2 q tiles x 8 kv heads = 16 blocks, each walking 16 key
// tiles, and no more: a wgmma takes 64 rows, so smaller q tiles would idle
// the tensor cores, and splitting the keys across blocks needs a second
// pass to merge the partials (m, l, acc) as the decode does. chip_smoke.py
// times the chunk against SDPA; on an H100 it takes less than SDPA without
// the split.
//
// Outputs: out in the input dtype, lse in fp32 (m + log l, NEG_INF where a
// row sees no key), l clamped at 1e-30 as _fwd_kernel does.

constexpr int FWD_STAGES = 2;

template <typename T, int D>
__global__ void __launch_bounds__(HB_THREADS)
fwd_hopper(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out, float* __restrict__ lse,
           const int* __restrict__ q_off, int B, int Sq, int Sk, int H, int KV, int win,
           float sm_scale) {
  constexpr int TILE = Tile<D>::BYTES, ST = FWD_STAGES;
  const int G = H / KV, block_q = HB_M / G, rows = block_q * G;
  const int nq = (Sq + block_q - 1) / block_q, nk = (Sk + HB_M - 1) / HB_M;
  // heaviest first: the last q tile sees the most key tiles
  const int pairs = KV * B;
  const int i = nq - 1 - (int)blockIdx.x / pairs;
  const int h = (int)blockIdx.x % pairs % KV, b = (int)blockIdx.x % pairs / KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qoff = q_off[b];
  const int first_q = qoff + i * block_q;                    // positions of the
  const int last_q = qoff + min((i + 1) * block_q, Sq) - 1;  // tile's queries
  // live key tiles [j_lo, j_lo + n_tiles): causal below, window above
  const int j_lo = win > 0 ? max(0, floor_div(first_q - win + 1, HB_M)) : 0;
  const int j_hi = last_q < 0 ? -1 : min(nk - 1, last_q / HB_M);
  const int n_tiles = max(0, j_hi - j_lo + 1);

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align_1024(smem_raw);  // Q, then K x ST, V x ST
  uint8_t* sk = sq + TILE;
  uint8_t* sv = sk + ST * TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + ST * TILE);  // q, kv stages
  const uint32_t a_q = smem_u32(sq), a_k = smem_u32(sk), a_v = smem_u32(sv),
                 bar_q = smem_u32(bars), bar_kv = bar_q + 8;

  if (rows < HB_M) {  // spare rows stay zero: the q box covers `rows` rows
    for (int e = tid; e < TILE / 16; e += HB_THREADS)
      reinterpret_cast<uint4*>(sq)[e] = make_uint4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  auto load_kv = [&](int t) {
    const uint32_t bar = bar_kv + 8 * (t % ST);
    mbar_expect_tx(bar, 2 * TILE);
    tma_tile<D>(a_k + (t % ST) * TILE, &tm_k, bar, h, (j_lo + t) * HB_M, b);
    tma_tile<D>(a_v + (t % ST) * TILE, &tm_v, bar, h, (j_lo + t) * HB_M, b);
  };
  if (tid == 0) {
    mbar_init(bar_q);
    for (int s = 0; s < ST; ++s) mbar_init(bar_kv + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_tiles > 0) {
      mbar_expect_tx(bar_q, rows * D * 2);
      tma_tile<D>(a_q, &tm_q, bar_q, h * G, i * block_q, b);
      for (int t = 0; t < ST && t < n_tiles; ++t) load_kv(t);
    }
  }
  __syncthreads();

  // this thread's two rows r0 and r0 + 8: their positions, and the running
  // max (log2 units) and partial sum of each
  const int r0 = 16 * warp + lane / 4;
  int qpos[2];
  float m2[2], l[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    qpos[u] = qoff + i * block_q + (r0 + 8 * u) / G;
    m2[u] = NEG_INF;
    l[u] = 0.f;
  }
  const float scale2 = sm_scale * LOG2E;

  float acc[D / 2];
  zero(acc);
  if (n_tiles > 0) mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % ST, k0 = (j_lo + t) * HB_M;
    mbar_wait(bar_kv + 8 * s, (t / ST) & 1);
    const uint32_t ks = a_k + s * TILE, vs = a_v + s * TILE;
    float sc[32];
    zero(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(sc, desc_k<D>(a_q, kk), desc_k<D>(ks, kk), T());
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // the element mask only where the tile crosses the diagonal, the
    // window edge or the ragged end of the keys
    const bool edge = k0 + HB_M > Sk || k0 + HB_M - 1 > first_q ||
                      (win > 0 && last_q - k0 >= win);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int u = (c >> 1) & 1;
      float x = sc[c] * scale2;
      if (edge) {
        const int kpos = k0 + 8 * (c >> 2) + 2 * (lane & 3) + (c & 1);
        const bool keep = kpos <= qpos[u] && kpos < Sk && window_keep(qpos[u], kpos, win);
        x = keep ? x : NEG_INF;
      }
      sc[c] = x;
      mx[u] = fmaxf(mx[u], x);
    }
    float alpha[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
      const float m_next = fmaxf(m2[u], mx[u]);
      alpha[u] = ex2(m2[u] - m_next);
      m2[u] = m_next;
      l[u] *= alpha[u];
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int c = 0; c < 32; c += 2) {
      const int u = (c >> 1) & 1;
      float p2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // explicit zeroing: while every key so far is masked m2 is still
        // NEG_INF and 2^(x - m2) would be 1, not 0
        float p = ex2(sc[c + e] - m2[u]);
        if (edge && sc[c + e] == NEG_INF) p = 0.f;
        l[u] += p;
        p2[e] = p;
      }
      pa[c >> 3][(c >> 1) & 3] = pack2<T>(p2[0], p2[1]);
    }
#pragma unroll
    for (int c = 0; c < D / 2; ++c) acc[c] *= alpha[(c >> 1) & 1];
    // O += P V: the keys are the contraction, V read transposed
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb(acc, pa[kk], desc_t<D>(vs, kk), T());
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && t + ST < n_tiles) load_kv(t + ST);
  }

  float lc[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
    lc[u] = fmaxf(l[u], 1e-30f);
  }
#pragma unroll
  for (int c = 0; c < D / 2; c += 2) {
    const int u = (c >> 1) & 1, r = r0 + 8 * u, qi = i * block_q + r / G;
    if (r >= rows || qi >= Sq) continue;
    const size_t row = ((size_t)b * Sq + qi) * H + h * G + r % G;
    *reinterpret_cast<uint32_t*>(out + row * D + 8 * (c >> 2) + 2 * (lane & 3)) =
        pack2<T>(acc[c] / lc[u], acc[c + 1] / lc[u]);
  }
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + 8 * u, qi = i * block_q + r / G;
      if (r >= rows || qi >= Sq) continue;
      const size_t row = ((size_t)b * Sq + qi) * H + h * G + r % G;
      lse[row] = (m2[u] == NEG_INF ? NEG_INF : m2[u] * LN2) + logf(lc[u]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(HB_THREADS)
bwd_dq_hopper(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
              const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              const float* __restrict__ lse, const float* __restrict__ di, T* __restrict__ dq,
              const int* __restrict__ q_off, int B, int Sq, int Sk, int H, int KV, int win,
              float sm_scale) {
  constexpr int TILE = Tile<D>::BYTES;
  const int G = H / KV, block_q = HB_M / G, rows = block_q * G;
  const int nq = (Sq + block_q - 1) / block_q, nk = (Sk + HB_M - 1) / HB_M;
  // heaviest first: the last q tile sees the most key tiles
  const int pairs = KV * B;
  const int i = nq - 1 - (int)blockIdx.x / pairs;
  const int h = (int)blockIdx.x % pairs % KV, b = (int)blockIdx.x % pairs / KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qoff = q_off[b];
  const int first_q = qoff + i * block_q;                    // positions of the
  const int last_q = qoff + min((i + 1) * block_q, Sq) - 1;  // tile's queries
  // live key tiles [j_lo, j_lo + n_tiles): causal below, window above
  const int j_lo = win > 0 ? max(0, floor_div(first_q - win + 1, HB_M)) : 0;
  const int j_hi = last_q < 0 ? -1 : min(nk - 1, last_q / HB_M);
  const int n_tiles = max(0, j_hi - j_lo + 1);

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align_1024(smem_raw);   // [64][D] Q, then dO, then K x2, V x2
  uint8_t* sdo = sq + TILE;
  uint8_t* sk = sdo + TILE;
  uint8_t* sv = sk + 2 * TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + 2 * TILE);  // q/do, kv stage 0, 1
  const uint32_t a_q = smem_u32(sq), a_do = smem_u32(sdo), a_k = smem_u32(sk),
                 a_v = smem_u32(sv), bar_q = smem_u32(bars), bar_kv = bar_q + 8;

  // spare rows (G not dividing 64) stay zero: the q box covers `rows` rows
  for (int e = tid; e < 2 * TILE / 16; e += HB_THREADS)
    reinterpret_cast<uint4*>(sq)[e] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  auto load_kv = [&](int t) {
    const uint32_t bar = bar_kv + 8 * (t & 1);
    mbar_expect_tx(bar, 2 * TILE);
    tma_tile<D>(a_k + (t & 1) * TILE, &tm_k, bar, h, (j_lo + t) * HB_M, b);
    tma_tile<D>(a_v + (t & 1) * TILE, &tm_v, bar, h, (j_lo + t) * HB_M, b);
  };
  if (tid == 0) {
    mbar_init(bar_q);
    mbar_init(bar_kv);
    mbar_init(bar_kv + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_tiles > 0) {
      mbar_expect_tx(bar_q, 2 * rows * D * 2);
      tma_tile<D>(a_q, &tm_q, bar_q, h * G, i * block_q, b);
      tma_tile<D>(a_do, &tm_do, bar_q, h * G, i * block_q, b);
      load_kv(0);
      if (n_tiles > 1) load_kv(1);
    }
  }
  __syncthreads();

  // this thread's two rows: lse and di, pre-scaled for exp2
  const int r0 = 16 * warp + lane / 4;
  float lse2[2], di_r[2];
  int qpos[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = r0 + 8 * u, qi = i * block_q + r / G;
    const bool valid = r < rows && qi < Sq;
    const size_t row = ((size_t)b * Sq + qi) * H + h * G + r % G;
    lse2[u] = valid ? lse[row] * LOG2E : 0.f;
    di_r[u] = valid ? di[row] : 0.f;
    qpos[u] = qoff + qi;
  }
  const float scale2 = sm_scale * LOG2E;

  float acc[D / 2];
  zero(acc);
  if (n_tiles > 0) mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1, j = j_lo + t, k0 = j * HB_M;
    mbar_wait(bar_kv + 8 * s, (t >> 1) & 1);
    const uint32_t ks = a_k + s * TILE, vs = a_v + s * TILE;
    float sc[32], dp[32];
    zero(sc);
    zero(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, desc_k<D>(a_q, kk), desc_k<D>(ks, kk), T());
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<D>(a_do, kk), desc_k<D>(vs, kk), T());
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // the element mask only where the tile crosses the diagonal, the
    // window edge or the ragged end of the keys
    const bool edge = k0 + HB_M > Sk || k0 + HB_M - 1 > first_q ||
                      (win > 0 && last_q - k0 >= win);
    uint32_t ds[4][4];
#pragma unroll
    for (int c = 0; c < 32; c += 2) {
      const int u = (c >> 1) & 1;
      float v2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p = ex2(fmaf(sc[c + e], scale2, -lse2[u]));
        if (edge) {
          const int kpos = k0 + 8 * (c >> 2) + 2 * (lane & 3) + e;
          const bool keep = kpos <= qpos[u] && kpos < Sk && window_keep(qpos[u], kpos, win);
          p = keep ? p : 0.f;
        }
        v2[e] = p * (dp[c + e] - di_r[u]) * sm_scale;
      }
      ds[c >> 3][(c >> 1) & 3] = pack2<T>(v2[0], v2[1]);
    }
    // dQ += dS K: the keys are the contraction, K read transposed
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb(acc, ds[kk], desc_t<D>(ks, kk), T());
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && t + 2 < n_tiles) load_kv(t + 2);
  }

#pragma unroll
  for (int c = 0; c < D / 2; c += 2) {
    const int r = r0 + 8 * ((c >> 1) & 1), qi = i * block_q + r / G;
    if (r >= rows || qi >= Sq) continue;
    const size_t row = ((size_t)b * Sq + qi) * H + h * G + r % G;
    *reinterpret_cast<uint32_t*>(dq + row * D + 8 * (c >> 2) + 2 * (lane & 3)) =
        pack2<T>(acc[c], acc[c + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(HB_THREADS)
bwd_dkv_hopper(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
               const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
               const float* __restrict__ lse, const float* __restrict__ di, T* __restrict__ dk,
               T* __restrict__ dv, const int* __restrict__ q_off, int B, int Sq, int Sk, int H,
               int KV, int win, float sm_scale) {
  constexpr int TILE = Tile<D>::BYTES;
  const int G = H / KV, block_q = HB_M / G, rows = block_q * G;
  const int nq = (Sq + block_q - 1) / block_q;
  // heaviest first: key tile 0 (seen by every query) of every (kv head,
  // batch) pair, then key tile 1, ...
  const int pairs = KV * B;
  const int j = (int)blockIdx.x / pairs;
  const int h = (int)blockIdx.x % pairs % KV, b = (int)blockIdx.x % pairs / KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qoff = q_off[b];
  const int k0 = j * HB_M, k_last = k0 + HB_M - 1;
  // live q tiles [i_lo, i_lo + n_tiles): the tile's newest query at or past
  // the oldest key, and (window) its oldest query within reach of the
  // newest key
  const int i_lo = max(0, -floor_div(qoff + block_q - 1 - k0, block_q));
  const int i_end = win > 0 ? min(nq, floor_div(k_last + win - 1 - qoff, block_q) + 1) : nq;
  const int n_tiles = max(0, i_end - i_lo);

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = align_1024(smem_raw);  // K, V, then Q x2, dO x2
  uint8_t* sv = sk + TILE;
  uint8_t* sq = sv + TILE;
  uint8_t* sdo = sq + 2 * TILE;
  float* slse = reinterpret_cast<float*>(sdo + 2 * TILE);  // [2][64], then di [2][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(slse + 4 * HB_M);  // kv, q/do stage 0, 1
  const uint32_t a_k = smem_u32(sk), a_v = smem_u32(sv), a_q = smem_u32(sq),
                 a_do = smem_u32(sdo), bar_kv = smem_u32(bars), bar_q = bar_kv + 8;

  for (int e = tid; e < 4 * TILE / 16; e += HB_THREADS)
    reinterpret_cast<uint4*>(sq)[e] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  auto load_q = [&](int t) {
    const int s = t & 1, i = i_lo + t;
    const uint32_t bar = bar_q + 8 * s;
    mbar_expect_tx(bar, 2 * rows * D * 2);
    tma_tile<D>(a_q + s * TILE, &tm_q, bar, h * G, i * block_q, b);
    tma_tile<D>(a_do + s * TILE, &tm_do, bar, h * G, i * block_q, b);
  };
  // lse (threads 0-63) and di (64-127) of q tile t's rows, zeros past Sq
  // and in the spare rows; one cp.async group a tile, empty past the end
  auto load_stats = [&](int t) {
    if (t < n_tiles) {
      const int r = tid & (HB_M - 1), qi = (i_lo + t) * block_q + r / G;
      const float* src = tid < HB_M ? lse : di;
      const bool valid = r < rows && qi < Sq;
      const size_t row = ((size_t)b * Sq + qi) * H + h * G + r % G;
      cp_async4(smem_u32(slse + (tid < HB_M ? 0 : 2 * HB_M) + (t & 1) * HB_M + r),
                valid ? src + row : src, valid ? 4 : 0);
    }
    cp_async_commit();
  };
  if (tid == 0) {
    mbar_init(bar_kv);
    mbar_init(bar_q);
    mbar_init(bar_q + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_tiles > 0) {
      mbar_expect_tx(bar_kv, 2 * TILE);
      tma_tile<D>(a_k, &tm_k, bar_kv, h, k0, b);
      tma_tile<D>(a_v, &tm_v, bar_kv, h, k0, b);
      load_q(0);
      if (n_tiles > 1) load_q(1);
    }
  }
  load_stats(0);
  load_stats(1);
  __syncthreads();

  const int c0 = 16 * warp + lane / 4;  // this thread's keys: k0 + c0, k0 + c0 + 8
  const float scale2 = sm_scale * LOG2E;
  float dk_acc[D / 2], dv_acc[D / 2];
  zero(dk_acc);
  zero(dv_acc);
  if (n_tiles > 0) mbar_wait(bar_kv, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1, i = i_lo + t;
    cp_async_wait<1>();  // this thread's lse/di copies of tile t ...
    __syncthreads();     // ... and every thread's
    mbar_wait(bar_q + 8 * s, (t >> 1) & 1);
    const uint32_t qs = a_q + s * TILE, dos = a_do + s * TILE;
    const float* ls = slse + s * HB_M;
    const float* dis = slse + 2 * HB_M + s * HB_M;
    float sc[32], dp[32];
    zero(sc);
    zero(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, desc_k<D>(a_k, kk), desc_k<D>(qs, kk), T());
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<D>(a_v, kk), desc_k<D>(dos, kk), T());
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const int first_q = qoff + i * block_q;
    const bool edge = k0 + HB_M > Sk || (i + 1) * block_q > Sq || k_last > first_q ||
                      (win > 0 && first_q + block_q - 1 - k0 >= win);
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int c = 0; c < 32; c += 2) {
      const int kpos = k0 + c0 + 8 * ((c >> 1) & 1);
      float p2[2], d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * (c >> 2) + 2 * (lane & 3) + e;  // row of the q tile
        float p = ex2(fmaf(sc[c + e], scale2, -ls[r] * LOG2E));
        if (edge) {
          const int qi = i * block_q + r / G, qp = qoff + qi;
          const bool keep = r < rows && qi < Sq && kpos <= qp && kpos < Sk &&
                            window_keep(qp, kpos, win);
          p = keep ? p : 0.f;
        }
        p2[e] = p;
        d2[e] = p * (dp[c + e] - dis[r]) * sm_scale;
      }
      pa[c >> 3][(c >> 1) & 3] = pack2<T>(p2[0], p2[1]);
      da[c >> 3][(c >> 1) & 3] = pack2<T>(d2[0], d2[1]);
    }
    // dV += P^T dO, dK += dS^T Q: the q rows are the contraction
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb(dv_acc, pa[kk], desc_t<D>(dos, kk), T());
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tb(dk_acc, da[kk], desc_t<D>(qs, kk), T());
    wg_commit();
    wg_wait_all();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && t + 2 < n_tiles) load_q(t + 2);
    load_stats(t + 2);
  }

#pragma unroll
  for (int c = 0; c < D / 2; c += 2) {
    const int kpos = k0 + c0 + 8 * ((c >> 1) & 1);
    if (kpos >= Sk) continue;
    const size_t off = (((size_t)b * Sk + kpos) * KV + h) * D + 8 * (c >> 2) + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(dk + off) = pack2<T>(dk_acc[c], dk_acc[c + 1]);
    *reinterpret_cast<uint32_t*>(dv + off) = pack2<T>(dv_acc[c], dv_acc[c + 1]);
  }
}

// ---------------------------------------------------------------------------
// the MLA route's backward on the tensor cores (bf16 / fp16)
// ---------------------------------------------------------------------------
//
// Replaces _dq_kernel and _dkv_kernel (src/repro/kernels/flash_attention.py)
// in the MLA absorbed layout: q (B, S, H, 576), k = latent || rope key (B, S,
// KV, 576), v = the latent (B, S, KV, 512), G = H / KV <= 16 query heads
// folded into the rows of a q tile. Bound by operations at the MLA shape
// (B 2, S 1024, 16 heads over 1): 2 (2 DK + DV) FLOPs a live (row, key) pair
// in dq and 4 (DK + DV) in dk/dv, against a few bytes of input a row and key.
//
// What the widths force. wgmma takes 64 rows; a 64 x 576 fp32 accumulator
// is 288 registers a thread of one warpgroup, and a 64-row q tile (73,728
// bytes) with its dO (65,536) and a 64-key K and V tile (139,264) are 272 KB
// of shared memory, over the 227 KB a block can have. So:
// - Two warpgroups a block (mla_bwd_tiles), one resident 64-row tile (A)
//   and a streamed tile of 32 rows (B) a step, every tile in panels of 64
//   values (128-byte rows, TMA's 128-byte swizzle). Each warpgroup computes
//   the scores of 16 of the step's 32 streamed rows (m64n16k16 from shared
//   memory: S = A1 B1^T over DK, dP = A2 B2^T over DV), turns them into dS
//   or P, and writes them, rounded to the input type, into one shared
//   [64][32] tile X in the swizzled layout wgmma reads. After a barrier
//   each warpgroup adds X times the streamed tile (read transposed) into
//   its half of the output columns (m64n64k16 a panel: 5 panels and 4 of
//   DK 576's 9, 4 and 4 of DV 512's 8), at most 160 fp32 registers a
//   thread. Shared memory: A1 + A2 + B1 + B2 + X = 217,088 bytes at (576,
//   512), one block an SM.
// - dq (bwd_dq_mla_hopper): the resident tile is a q tile (Q and dO), the
//   streamed one 32 keys (K and V), X = dS, dQ += dS K. One block a q tile,
//   the last q tiles (most keys) first.
// - dk/dv (bwd_dkv_mla_hopper): the resident tile is 64 keys (K, and V for
//   dk), the streamed one 32 q rows (Q and dO) in transposed form (keys are
//   the M side): dk blocks X = dS^T and dK += dS^T Q; dv blocks skip dP,
//   X = P^T and dV += P^T dO. dK and dV are separate blocks (their
//   accumulators would not fit one), and a key tile's live q tiles are cut
//   into chunks of `chunk` tiles counted from its first live one
//   (mla_dkv_live; mla_dkv_plan in kernels/flash_attention.py picks
//   `chunk` so that the card holds about two live blocks an SM), each
//   block writing its fp32 partial to a scratch buffer; mla_dkv_reduce then
//   sums a key's live chunks in chunk order and casts. No atomics: two
//   calls agree bit for bit. The flat grid runs chunk 0 of every key tile
//   first (dk before dv, key tile 0 first), then chunk 1, ...; a block
//   whose chunk holds no live q tile returns at once and writes nothing,
//   and the reduction never reads it.
// The tile's loads (TMA, completed on mbarriers) overlap the other
// products: the tile only the scores read (V or dO for dq/dk, Q for dv) is
// reloaded for the next step as soon as the scores are done, the other
// once the product is. Numerics as the D <= 128 kernels: p = 2^(s sm_scale
// log2 e - lse log2 e), the element mask only on tiles that cross the
// diagonal, the window edge or a ragged end, dS rounded to k's dtype (dq)
// and q's (dk), P to do's (dv), fp32 sums.

constexpr int MB_THREADS = 256;                // two warpgroups
constexpr int MB_N = 32;                       // streamed rows a step
constexpr int MB_PANEL_A = HB_M * 128;         // a resident panel: 64 rows x 64 values
constexpr int MB_PANEL_B = MB_N * 128;         // a streamed panel: 32 rows x 64 values
constexpr int MLA_TC_DK = 576, MLA_TC_DV = 512;  // the one pair they are built for

template <int DK, int DV> struct MlaBwd {
  static_assert(DK % 64 == 0 && DV % 64 == 0, "head dims in panels of 64 values");
  static constexpr int PK = DK / 64, PV = DV / 64;
  static constexpr int A1 = 0, A2 = PK * MB_PANEL_A;   // resident tiles
  static constexpr int B1 = A2 + PV * MB_PANEL_A;      // streamed tiles
  static constexpr int B2 = B1 + PK * MB_PANEL_B;
  static constexpr int X = B2 + PV * MB_PANEL_B;       // dS or P: [64][64], 32 used
  static constexpr int BARS = X + HB_M * 128;          // 3 mbarriers
  static constexpr int SMEM = BARS + 3 * 8 + 1024;     // + 1024-byte alignment
};

// the P panels of a tile by TMA: box (64, n, s, 1) at (64 p, c1, c2, c3)
__device__ __forceinline__ void tma_panels(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                           int P, int panel, int c1, int c2, int c3) {
  for (int p = 0; p < P; ++p) tma_load(dst + p * panel, map, bar, 64 * p, c1, c2, c3);
}

// k-step kk of a K-major operand in panels of `panel` bytes: panel kk / 4,
// 32 bytes a step along the rows (the rows may start inside a panel)
__device__ __forceinline__ uint64_t mla_desc_k(uint32_t tile, int panel, int kk) {
  return gmma_desc<64>(tile + (kk >> 2) * panel + (kk & 3) * 32, 16);
}

// k-step kk (rows 16 kk ..) of one panel read transposed (N = its 64 values)
__device__ __forceinline__ uint64_t mla_desc_t(uint32_t panel, int kk) {
  return gmma_desc<64>(panel + kk * 16 * 128, 16);
}

// live q tiles [lo, lo + n) of dk/dv's key tile j (64 keys) for q tiles of
// block_q queries: the tile's newest query at or past the oldest key, and
// (window) its oldest query within reach of the newest key
__device__ __forceinline__ void mla_dkv_live(int j, int qoff, int win, int nq, int block_q,
                                             int& lo, int& n) {
  const int k0 = j * HB_M, k_last = k0 + HB_M - 1;
  lo = max(0, -floor_div(qoff + block_q - 1 - k0, block_q));
  const int end = win > 0 ? min(nq, floor_div(k_last + win - 1 - qoff, block_q) + 1) : nq;
  n = max(0, end - lo);
}

// MODE 0: dq. The resident tile is q tile `tile` (64 / G queries x G heads,
// Q = A1, dO = A2), step t streams key tile s_lo + t (32 keys, K = B1, V =
// B2); out = dq. MODE 1 (dk) / 2 (dv): the resident tile is key tile `tile`
// (64 keys, K = A1, V = A2), step t streams q tile s_lo + t (32 / G queries,
// Q = B1, dO = B2); out = this chunk's fp32 partial (B, Sk, KV, DK or DV).
template <typename T, int DK, int DV, int MODE>
__device__ __forceinline__ void mla_bwd_tiles(
    uint8_t* sm, const CUtensorMap* tm_a1, const CUtensorMap* tm_a2, const CUtensorMap* tm_b1,
    const CUtensorMap* tm_b2, const float* __restrict__ lse, const float* __restrict__ di,
    void* out, int b, int h, int tile, int s_lo, int n_steps, int qoff, int Sq, int Sk, int H,
    int KV, int win, float sm_scale) {
  using L = MlaBwd<DK, DV>;
  constexpr bool DQ = MODE == 0, DP = MODE != 2;   // dv needs no dP
  constexpr int WX = MODE == 2 ? DV : DK;          // output columns
  constexpr int NPX = WX / 64, NPW = (NPX + 1) / 2;  // panels: all, a warpgroup's most
  const int G = H / KV;
  const int bq = (DQ ? HB_M : MB_N) / G;  // queries of a q tile (resident or streamed)
  const int rows = bq * G;                // its rows; the spare ones stay zero
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int m0 = 16 * (tid / 32 % 4) + lane / 4;   // this thread's rows m0, m0 + 8
  const uint32_t a1 = smem_u32(sm + L::A1), a2 = smem_u32(sm + L::A2),
                 b1 = smem_u32(sm + L::B1), b2 = smem_u32(sm + L::B2), x = smem_u32(sm + L::X),
                 bar_a = smem_u32(sm + L::BARS), bar_b1 = bar_a + 8, bar_b2 = bar_a + 16;

  // spare rows of the q tiles (G not dividing 64 or 32): TMA never writes them
  if (rows < (DQ ? HB_M : MB_N)) {
    const int lo = DQ ? L::A1 : L::B1, hi = DQ ? L::B1 : L::X;
    for (int e = lo / 16 + tid; e < hi / 16; e += MB_THREADS)
      reinterpret_cast<uint4*>(sm)[e] = make_uint4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  // step t's streamed tile: B1 (DK wide) or B2 (DV wide)
  auto load_b = [&](bool first, int t) {
    const int s = s_lo + t, P = first ? L::PK : L::PV;
    const uint32_t dst = first ? b1 : b2, bar = first ? bar_b1 : bar_b2;
    const CUtensorMap* map = first ? tm_b1 : tm_b2;
    if (DQ) {
      mbar_expect_tx(bar, MB_N * P * 128);
      tma_panels(dst, map, bar, P, MB_PANEL_B, h, s * MB_N, b);
    } else {
      mbar_expect_tx(bar, rows * P * 128);
      tma_panels(dst, map, bar, P, MB_PANEL_B, h * G, s * bq, b);
    }
  };
  if (tid == 0) {
    mbar_init(bar_a);
    mbar_init(bar_b1);
    mbar_init(bar_b2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_steps > 0) {
      if (DQ) {
        mbar_expect_tx(bar_a, rows * (DK + DV) * 2);
        tma_panels(a1, tm_a1, bar_a, L::PK, MB_PANEL_A, h * G, tile * bq, b);
        tma_panels(a2, tm_a2, bar_a, L::PV, MB_PANEL_A, h * G, tile * bq, b);
      } else {
        mbar_expect_tx(bar_a, HB_M * (DK + (DP ? DV : 0)) * 2);
        tma_panels(a1, tm_a1, bar_a, L::PK, MB_PANEL_A, h, tile * HB_M, b);
        if (DP) tma_panels(a2, tm_a2, bar_a, L::PV, MB_PANEL_A, h, tile * HB_M, b);
      }
      load_b(true, 0);
      load_b(false, 0);
    }
  }
  __syncthreads();

  // dq: lse and di of this thread's two resident rows, pre-scaled for exp2
  float lse_r[2] = {0.f, 0.f}, di_r[2] = {0.f, 0.f};
  int qpos_r[2] = {0, 0};
  if (DQ) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int m = m0 + 8 * u, qi = tile * bq + m / G;
      const bool valid = m < rows && qi < Sq;
      const size_t row = ((size_t)b * Sq + qi) * H + h * G + m % G;
      lse_r[u] = valid ? lse[row] * LOG2E : 0.f;
      di_r[u] = valid ? di[row] : 0.f;
      qpos_r[u] = qoff + qi;
    }
  }
  const int first_q = qoff + tile * bq;                      // dq: the resident
  const int last_q = qoff + min((tile + 1) * bq, Sq) - 1;    // tile's queries
  const float scale2 = sm_scale * LOG2E;

  float acc[NPW][32];
#pragma unroll
  for (int pp = 0; pp < NPW; ++pp) zero(acc[pp]);
  if (n_steps > 0) mbar_wait(bar_a, 0);
  for (int t = 0; t < n_steps; ++t) {
    const int s = s_lo + t;
    // dk/dv: lse and di of this thread's four streamed q rows 16 wg + 2
    // (lane & 3) + (e & 1) + 8 (e >> 1), read before the scores' wait
    float st_l[4] = {0.f, 0.f, 0.f, 0.f}, st_d[4] = {0.f, 0.f, 0.f, 0.f};
    int st_q[4] = {0, 0, 0, 0};
    bool st_v[4] = {false, false, false, false};
    if (!DQ) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * wg + 2 * (lane & 3) + (e & 1) + 8 * (e >> 1), qi = s * bq + r / G;
        st_v[e] = r < rows && qi < Sq;
        const size_t row = ((size_t)b * Sq + qi) * H + h * G + r % G;
        st_l[e] = st_v[e] ? lse[row] * LOG2E : 0.f;
        st_d[e] = st_v[e] ? di[row] : 0.f;
        st_q[e] = qoff + qi;
      }
    }
    // S and dP of this warpgroup's 16 streamed rows. dP first (dq, dk):
    // its tile was reloaded before the last product, B1 only after it, so
    // B1's load runs under dP's wgmmas
    float sc[8], dp[8];
    zero(sc);
    zero(dp);
    const uint32_t b1w = b1 + 16 * wg * 128, b2w = b2 + 16 * wg * 128;
    wg_fence();
    if (DP) {
      mbar_wait(bar_b2, t & 1);
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss_n16(dp, mla_desc_k(a2, MB_PANEL_A, kk), mla_desc_k(b2w, MB_PANEL_B, kk), T());
      wg_commit();
    }
    mbar_wait(bar_b1, t & 1);
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_ss_n16(sc, mla_desc_k(a1, MB_PANEL_A, kk), mla_desc_k(b1w, MB_PANEL_B, kk), T());
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // the element mask only where the tile crosses the diagonal, the
    // window edge or a ragged end
    bool edge;
    if (DQ) {
      const int k0 = s * MB_N;
      edge = rows < HB_M || k0 + MB_N > Sk || k0 + MB_N - 1 > first_q ||
             (win > 0 && last_q - k0 >= win);
    } else {
      const int k0 = tile * HB_M, fq = qoff + s * bq;
      edge = rows < MB_N || k0 + HB_M > Sk || (s + 1) * bq > Sq || k0 + HB_M - 1 > fq ||
             (win > 0 && fq + bq - 1 - k0 >= win);
    }
    // dS (dq, dk) or P (dv) into X[m][16 wg + n], rounded to T: element c
    // of the m64n16 accumulator is row m0 + 8 ((c >> 1) & 1), column n = 8
    // (c >> 2) + 2 (lane & 3) + (c & 1); X rows are 128 bytes, 16-byte
    // chunk q of row m at chunk q ^ (m & 7) (TMA's 128-byte swizzle)
#pragma unroll
    for (int c = 0; c < 8; c += 2) {
      const int u = (c >> 1) & 1, m = m0 + 8 * u, n = 8 * (c >> 2) + 2 * (lane & 3);
      float x2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p, d_i;
        if (DQ) {
          p = ex2(fmaf(sc[c + e], scale2, -lse_r[u]));
          if (edge) {
            const int kpos = s * MB_N + 16 * wg + n + e, qi = tile * bq + m / G;
            const bool keep = m < rows && qi < Sq && kpos <= qpos_r[u] && kpos < Sk &&
                              window_keep(qpos_r[u], kpos, win);
            p = keep ? p : 0.f;
          }
          d_i = di_r[u];
        } else {
          const int ei = e + 2 * (c >> 2);
          p = ex2(fmaf(sc[c + e], scale2, -st_l[ei]));
          if (edge) {
            const int kpos = tile * HB_M + m;
            const bool keep = st_v[ei] && kpos <= st_q[ei] && kpos < Sk &&
                              window_keep(st_q[ei], kpos, win);
            p = keep ? p : 0.f;
          }
          d_i = st_d[ei];
        }
        x2[e] = DP ? p * (dp[c + e] - d_i) * sm_scale : p;
      }
      const int byte = (16 * wg + n) * 2;
      *reinterpret_cast<uint32_t*>(sm + L::X + m * 128 + (((byte >> 4) ^ (m & 7)) << 4) +
                                   (byte & 15)) = pack2<T>(x2[0], x2[1]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // X whole; every warpgroup done with the scores' tiles
    // the tile only the scores read: V / dO (dq, dk) or Q (dv)
    if (tid == 0 && t + 1 < n_steps) load_b(!DP, t + 1);
    if (!DP) mbar_wait(bar_b2, t & 1);
    // out[:, this warpgroup's panels] += X (64 x 32) times the streamed
    // tile read transposed: K (dq), Q (dk) or dO (dv). Where the panels
    // split unevenly (DK 576: 5 and 4) the second warpgroup repeats its
    // last panel into a slot it never stores: no branch around the wgmma
    // (a divergent one makes ptxas serialize them)
    const uint32_t bx = DP ? b1 : b2;
    wg_fence();
#pragma unroll
    for (int pp = 0; pp < NPW; ++pp) {
      const int p = min(wg * NPW + pp, NPX - 1);
#pragma unroll
      for (int kk = 0; kk < MB_N / 16; ++kk)
        wgmma_ss_tb(acc[pp], gmma_desc<64>(x + kk * 32, 16),
                    mla_desc_t(bx + p * MB_PANEL_B, kk), T());
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int pp = 0; pp < NPW; ++pp) fence_regs(acc[pp]);
    __syncthreads();  // every warpgroup done with X and the product's tile
    if (tid == 0 && t + 1 < n_steps) load_b(DP, t + 1);
  }

  // accumulator element c of panel p: row m0 + 8 ((c >> 1) & 1), column
  // 64 p + 8 (c >> 2) + 2 (lane & 3) + (c & 1)
#pragma unroll
  for (int pp = 0; pp < NPW; ++pp) {
    const int p = wg * NPW + pp;
    if (p >= NPX) continue;
#pragma unroll
    for (int c = 0; c < 32; c += 2) {
      const int m = m0 + 8 * ((c >> 1) & 1), col = 64 * p + 8 * (c >> 2) + 2 * (lane & 3);
      if (DQ) {
        const int qi = tile * bq + m / G;
        if (m >= rows || qi >= Sq) continue;
        const size_t row = ((size_t)b * Sq + qi) * H + h * G + m % G;
        *reinterpret_cast<uint32_t*>(static_cast<T*>(out) + row * DK + col) =
            pack2<T>(acc[pp][c], acc[pp][c + 1]);
      } else {
        const int kpos = tile * HB_M + m;
        if (kpos >= Sk) continue;
        *reinterpret_cast<float2*>(static_cast<float*>(out) +
                                   (((size_t)b * Sk + kpos) * KV + h) * WX + col) =
            make_float2(acc[pp][c], acc[pp][c + 1]);
      }
    }
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(MB_THREADS, 1)
bwd_dq_mla_hopper(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                  const float* __restrict__ di, T* __restrict__ dq,
                  const int* __restrict__ q_off, int B, int Sq, int Sk, int H, int KV, int win,
                  float sm_scale) {
  const int G = H / KV, block_q = HB_M / G;
  const int nq = (Sq + block_q - 1) / block_q, nk = (Sk + MB_N - 1) / MB_N;
  // heaviest first: the last q tile sees the most key tiles
  const int pairs = KV * B;
  const int i = nq - 1 - (int)blockIdx.x / pairs;
  const int h = (int)blockIdx.x % pairs % KV, b = (int)blockIdx.x % pairs / KV;
  const int qoff = q_off[b];
  const int first_q = qoff + i * block_q, last_q = qoff + min((i + 1) * block_q, Sq) - 1;
  // live key tiles of 32 keys [j_lo, j_hi]: causal below, window above
  const int j_lo = win > 0 ? max(0, floor_div(first_q - win + 1, MB_N)) : 0;
  const int j_hi = last_q < 0 ? -1 : min(nk - 1, last_q / MB_N);
  extern __shared__ uint8_t smem_raw[];
  mla_bwd_tiles<T, DK, DV, 0>(align_1024(smem_raw), &tm_q, &tm_do, &tm_k, &tm_v, lse, di, dq,
                              b, h, i, j_lo, max(0, j_hi - j_lo + 1), qoff, Sq, Sk, H, KV, win,
                              sm_scale);
}

// part: n_chunks x (dk partials (B, Sk, KV, DK), then dv partials (B, Sk,
// KV, DV)), fp32; block x takes chunk x / (2 nk KV B), then dk (0) or dv
// (1), key tile, (batch, kv head)
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(MB_THREADS, 1)
bwd_dkv_mla_hopper(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                   const float* __restrict__ di, float* __restrict__ part,
                   const int* __restrict__ q_off, int B, int Sq, int Sk, int H, int KV, int win,
                   float sm_scale, int chunk) {
  const int G = H / KV, block_q = MB_N / G;
  const int nq = (Sq + block_q - 1) / block_q, nk = (Sk + HB_M - 1) / HB_M;
  const int pairs = KV * B, per_part = nk * pairs;
  const int c = (int)blockIdx.x / (2 * per_part), r = (int)blockIdx.x % (2 * per_part);
  const int which = r / per_part, j = r % per_part / pairs;
  const int h = r % pairs % KV, b = r % pairs / KV;
  const int qoff = q_off[b];
  int lo, n;
  mla_dkv_live(j, qoff, win, nq, block_q, lo, n);
  const int s_lo = lo + c * chunk, n_steps = min(chunk, lo + n - s_lo);
  if (n_steps <= 0) return;  // a dead chunk: nothing written, never read
  const size_t all_rows = (size_t)B * Sk * KV;
  float* base = part + (size_t)c * all_rows * (DK + DV);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  if (which == 0)
    mla_bwd_tiles<T, DK, DV, 1>(sm, &tm_k, &tm_v, &tm_q, &tm_do, lse, di, base, b, h, j, s_lo,
                                n_steps, qoff, Sq, Sk, H, KV, win, sm_scale);
  else
    mla_bwd_tiles<T, DK, DV, 2>(sm, &tm_k, &tm_v, &tm_q, &tm_do, lse, di,
                                base + all_rows * DK, b, h, j, s_lo, n_steps, qoff, Sq, Sk, H,
                                KV, win, sm_scale);
}

// dk, dv (B, Sk, KV, D) in T: each key row's live chunks of `part` summed
// in chunk order (0 + chunk 0 + chunk 1 + ...); one block a row
constexpr int MR_THREADS = 256;

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(MR_THREADS)
mla_dkv_reduce(const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
               const int* __restrict__ q_off, int B, int Sq, int Sk, int H, int KV, int win,
               int chunk) {
  const int row = blockIdx.x;  // ((b * Sk + kpos) * KV + h)
  const int kpos = row / KV % Sk, b = row / KV / Sk;
  const int block_q = MB_N / (H / KV), nq = (Sq + block_q - 1) / block_q;
  int lo, n;
  mla_dkv_live(kpos / HB_M, q_off[b], win, nq, block_q, lo, n);
  const int n_live = (n + chunk - 1) / chunk;
  const size_t all_rows = (size_t)B * Sk * KV, per_chunk = all_rows * (DK + DV);
  for (int e = threadIdx.x; e < (DK + DV) / 4; e += MR_THREADS) {
    const bool is_k = e < DK / 4;
    const size_t off = is_k ? (size_t)row * DK + 4 * e
                            : all_rows * DK + (size_t)row * DV + 4 * (e - DK / 4);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < n_live; ++c) {
      const float4 v4 = *reinterpret_cast<const float4*>(part + c * per_chunk + off);
      sum.x += v4.x;
      sum.y += v4.y;
      sum.z += v4.z;
      sum.w += v4.w;
    }
    T* dst = is_k ? dk + (size_t)row * DK + 4 * e : dv + (size_t)row * DV + 4 * (e - DK / 4);
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack2<T>(sum.x, sum.y), pack2<T>(sum.z, sum.w));
  }
}

// ---------------------------------------------------------------------------
// the MLA route's forward on the tensor cores (bf16 / fp16)
// ---------------------------------------------------------------------------
//
// Replaces _fwd_kernel (src/repro/kernels/flash_attention.py) in the MLA
// absorbed layout (q (B, S, H, 576), k = latent || rope key (B, S, KV, 576),
// v = the latent (B, S, KV, 512), G = H / KV <= 16 heads folded into the
// rows of a q tile). Bound by operations at the MLA shape (B 2, S 1024, 16
// heads over 1): 2 (DK + DV) FLOPs a live (row, key) pair against a few
// bytes of input a row and key.
//
// It is mla_bwd_tiles' dq (MODE 0) with no dO tile and no dP product, P in
// place of dS, an online softmax, and O += P V in place of dQ += dS K:
// - A block owns one q tile of 64 rows (64 / G queries x G heads; the
//   spare rows of G not dividing 64 are zeroed once and never stored), Q
//   resident in 9 panels of 64 values (73,728 bytes), and walks its live
//   key tiles of 32 keys, the last q tiles (most keys) first. K (9 panels,
//   36,864 bytes) and V (8, 32,768) stream by TMA through a ring of
//   MF_STAGES = 2 stages on mbarriers, so the next tile's loads run under
//   this tile's products. With X and the exchange: 222,744 bytes, one
//   block an SM.
// - Two warpgroups. Each scores 16 of the tile's 32 keys over all 576
//   columns (m64n16k16 from shared memory, as dq does) and owns 4 of the
//   output's 8 column panels (64 x 256 fp32: 128 registers a thread; one
//   warpgroup with all 8 would need 256). A row's tile maximum crosses
//   the warpgroups once a tile through shared memory, so both take the
//   same m_next and alpha; each writes its half of P, rounded to v's
//   dtype, into one swizzled [64][32] tile X (as dq writes dS), and after
//   a barrier adds X V (V read transposed, m64n64k16 a panel) into its 4
//   panels. Each keeps l over its own 16 keys of every tile; the two are
//   added once at the end, before the divide and the lse.
// Scoring all 32 keys in each warpgroup instead (m64n32, P as the register
// A operand, no X and no exchange) would cost 2 DK + DV FLOPs a pair
// where this costs DK + DV: 1.53x at (576, 512). Two variants were timed
// beside this one on an H100: issuing the next tile's scores before this
// tile's softmax was slower (ptxas serializes the in-flight accumulators
// with injected waits); taking V's panels from the K tile (V is K's
// first 512 columns in this layout) with a third stage in the freed
// space was faster by a few percent, but needs v passed as a view of k
// and a second kernel for the unaliased case, so it is left for later.
//
// Numerics as fwd_hopper: p = 2^(s sm_scale log2 e - m log2 e), masked p
// zeroed explicitly, P rounded to v's dtype while l sums the unrounded p,
// fp32 sums, l clamped at 1e-30, lse = m + log l (NEG_INF where a row sees
// no key). The element mask runs only on tiles that cross the diagonal,
// the window edge or a ragged end of the keys. No atomics: two calls agree
// bit for bit.

constexpr int MF_STAGES = 2;

template <int DK, int DV> struct MlaFwd {
  static_assert(DK % 64 == 0 && DV % 64 == 0 && DV % 128 == 0,
                "head dims in panels of 64 values, DV's split over two warpgroups");
  static constexpr int PK = DK / 64, PV = DV / 64;
  static constexpr int KB = PK * MB_PANEL_B, VB = PV * MB_PANEL_B;  // a stage's K, V
  static constexpr int Q = 0;
  static constexpr int K = Q + PK * MB_PANEL_A;     // MF_STAGES K tiles
  static constexpr int V = K + MF_STAGES * KB;      // MF_STAGES V tiles
  static constexpr int X = V + MF_STAGES * VB;      // P: [64][64], 32 used
  static constexpr int RED = X + HB_M * 128;        // [2][64] fp32: tile maxima, then l
  static constexpr int BARS = RED + 2 * HB_M * 4;   // q, then one a stage
  static constexpr int SMEM = BARS + (1 + MF_STAGES) * 8 + 1024;  // + 1024-byte alignment
};

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(MB_THREADS, 1)
fwd_mla_hopper(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out,
               float* __restrict__ lse, const int* __restrict__ q_off, int B, int Sq, int Sk,
               int H, int KV, int win, float sm_scale) {
  using L = MlaFwd<DK, DV>;
  constexpr int ST = MF_STAGES, NPW = L::PV / 2;  // output panels a warpgroup
  const int G = H / KV, block_q = HB_M / G, rows = block_q * G;
  const int nq = (Sq + block_q - 1) / block_q, nk = (Sk + MB_N - 1) / MB_N;
  // heaviest first: the last q tile sees the most key tiles
  const int pairs = KV * B;
  const int i = nq - 1 - (int)blockIdx.x / pairs;
  const int h = (int)blockIdx.x % pairs % KV, b = (int)blockIdx.x % pairs / KV;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int m0 = 16 * (tid / 32 % 4) + lane / 4;  // this thread's rows m0, m0 + 8
  const int qoff = q_off[b];
  const int first_q = qoff + i * block_q, last_q = qoff + min((i + 1) * block_q, Sq) - 1;
  // live key tiles of 32 keys [j_lo, j_lo + n_tiles): causal below, window above
  const int j_lo = win > 0 ? max(0, floor_div(first_q - win + 1, MB_N)) : 0;
  const int j_hi = last_q < 0 ? -1 : min(nk - 1, last_q / MB_N);
  const int n_tiles = max(0, j_hi - j_lo + 1);

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  float* red = reinterpret_cast<float*>(sm + L::RED);
  const uint32_t a_q = smem_u32(sm + L::Q), a_k = smem_u32(sm + L::K),
                 a_v = smem_u32(sm + L::V), x = smem_u32(sm + L::X),
                 bar_q = smem_u32(sm + L::BARS), bar_kv = bar_q + 8;

  if (rows < HB_M) {  // spare rows stay zero: the q box covers `rows` rows
    for (int e = tid; e < L::K / 16; e += MB_THREADS)
      reinterpret_cast<uint4*>(sm + L::Q)[e] = make_uint4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  auto load_kv = [&](int t) {
    const int s = t % ST;
    const uint32_t bar = bar_kv + 8 * s;
    mbar_expect_tx(bar, MB_N * (DK + DV) * 2);
    tma_panels(a_k + s * L::KB, &tm_k, bar, L::PK, MB_PANEL_B, h, (j_lo + t) * MB_N, b);
    tma_panels(a_v + s * L::VB, &tm_v, bar, L::PV, MB_PANEL_B, h, (j_lo + t) * MB_N, b);
  };
  if (tid == 0) {
    mbar_init(bar_q);
    for (int s = 0; s < ST; ++s) mbar_init(bar_kv + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_tiles > 0) {
      mbar_expect_tx(bar_q, rows * DK * 2);
      tma_panels(a_q, &tm_q, bar_q, L::PK, MB_PANEL_A, h * G, i * block_q, b);
      for (int t = 0; t < ST && t < n_tiles; ++t) load_kv(t);
    }
  }
  __syncthreads();

  // this thread's rows m0 and m0 + 8: their positions, the running max
  // (log2 units; the same in both warpgroups) and this warpgroup's sum
  int qpos[2];
  float m2[2], l[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    qpos[u] = qoff + i * block_q + (m0 + 8 * u) / G;
    m2[u] = NEG_INF;
    l[u] = 0.f;
  }
  const float scale2 = sm_scale * LOG2E;

  float acc[NPW][32];
#pragma unroll
  for (int pp = 0; pp < NPW; ++pp) zero(acc[pp]);
  if (n_tiles > 0) mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % ST, k0 = (j_lo + t) * MB_N;
    const uint32_t ks = a_k + s * L::KB, vs = a_v + s * L::VB;
    mbar_wait(bar_kv + 8 * s, (t / ST) & 1);
    // S of this warpgroup's 16 keys, k0 + 16 wg ..
    float sc[8];
    zero(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_ss_n16(sc, mla_desc_k(a_q, MB_PANEL_A, kk),
                   mla_desc_k(ks + 16 * wg * 128, MB_PANEL_B, kk), T());
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // element c of the m64n16 accumulator: row m0 + 8 ((c >> 1) & 1), key
    // k0 + 16 wg + 8 (c >> 2) + 2 (lane & 3) + (c & 1); the element mask
    // only where the tile crosses the diagonal, the window edge or the
    // ragged end of the keys
    const bool edge = k0 + MB_N > Sk || k0 + MB_N - 1 > first_q ||
                      (win > 0 && last_q - k0 >= win);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int u = (c >> 1) & 1;
      float xv = sc[c] * scale2;
      if (edge) {
        const int kpos = k0 + 16 * wg + 8 * (c >> 2) + 2 * (lane & 3) + (c & 1);
        const bool keep = kpos <= qpos[u] && kpos < Sk && window_keep(qpos[u], kpos, win);
        xv = keep ? xv : NEG_INF;
      }
      sc[c] = xv;
      mx[u] = fmaxf(mx[u], xv);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
      if ((lane & 3) == 0) red[wg * HB_M + m0 + 8 * u] = mx[u];
    }
    __syncthreads();  // both warpgroups' tile maxima
    float alpha[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int m = m0 + 8 * u;
      const float m_next = fmaxf(m2[u], fmaxf(red[m], red[HB_M + m]));
      alpha[u] = ex2(m2[u] - m_next);
      m2[u] = m_next;
      l[u] *= alpha[u];
    }
    // P into X[m][16 wg + n], rounded to T; X rows are 128 bytes, 16-byte
    // chunk q of row m at chunk q ^ (m & 7) (TMA's 128-byte swizzle)
#pragma unroll
    for (int c = 0; c < 8; c += 2) {
      const int u = (c >> 1) & 1, m = m0 + 8 * u, n = 8 * (c >> 2) + 2 * (lane & 3);
      float p2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // explicit zeroing: while every key so far is masked m2 is still
        // NEG_INF and 2^(x - m2) would be 1, not 0
        float p = ex2(sc[c + e] - m2[u]);
        if (edge && sc[c + e] == NEG_INF) p = 0.f;
        l[u] += p;
        p2[e] = p;
      }
      const int byte = (16 * wg + n) * 2;
      *reinterpret_cast<uint32_t*>(sm + L::X + m * 128 + (((byte >> 4) ^ (m & 7)) << 4) +
                                   (byte & 15)) = pack2<T>(p2[0], p2[1]);
    }
#pragma unroll
    for (int pp = 0; pp < NPW; ++pp)
#pragma unroll
      for (int c = 0; c < 32; ++c) acc[pp][c] *= alpha[(c >> 1) & 1];
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // X whole
    // O[:, this warpgroup's panels] += X (64 x 32) V (each panel read
    // transposed: the keys are the contraction)
    wg_fence();
#pragma unroll
    for (int pp = 0; pp < NPW; ++pp)
#pragma unroll
      for (int kk = 0; kk < MB_N / 16; ++kk)
        wgmma_ss_tb(acc[pp], gmma_desc<64>(x + kk * 32, 16),
                    mla_desc_t(vs + (wg * NPW + pp) * MB_PANEL_B, kk), T());
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int pp = 0; pp < NPW; ++pp) fence_regs(acc[pp]);
    __syncthreads();  // every warpgroup done with X and stage s
    if (tid == 0 && t + ST < n_tiles) load_kv(t + ST);
  }

  // l of the two warpgroups' keys, added in one order in both
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
    if ((lane & 3) == 0) red[wg * HB_M + m0 + 8 * u] = l[u];
  }
  __syncthreads();
  float lc[2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
    lc[u] = fmaxf(red[m0 + 8 * u] + red[HB_M + m0 + 8 * u], 1e-30f);
  // accumulator element c of panel p: row m0 + 8 ((c >> 1) & 1), column
  // 64 p + 8 (c >> 2) + 2 (lane & 3) + (c & 1)
#pragma unroll
  for (int pp = 0; pp < NPW; ++pp) {
    const int p = wg * NPW + pp;
#pragma unroll
    for (int c = 0; c < 32; c += 2) {
      const int u = (c >> 1) & 1, m = m0 + 8 * u, qi = i * block_q + m / G;
      if (m >= rows || qi >= Sq) continue;
      const size_t row = ((size_t)b * Sq + qi) * H + h * G + m % G;
      *reinterpret_cast<uint32_t*>(out + row * DV + 64 * p + 8 * (c >> 2) + 2 * (lane & 3)) =
          pack2<T>(acc[pp][c] / lc[u], acc[pp][c + 1] / lc[u]);
    }
  }
  if (lse != nullptr && wg == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int m = m0 + 8 * u, qi = i * block_q + m / G;
      if (m >= rows || qi >= Sq) continue;
      const size_t row = ((size_t)b * Sq + qi) * H + h * G + m % G;
      lse[row] = (m2[u] == NEG_INF ? NEG_INF : m2[u] * LN2) + logf(lc[u]);
    }
  }
}

// ---------------------------------------------------------------------------
// split-KV decode: one block per (key chunk, kv head [x row group], slot),
// then one combine block per (kv head, slot)
// ---------------------------------------------------------------------------
//
// Bound by bytes: the G query rows of a KV group do 4 G FLOPs for each pair
// of K and V values read (2 G a byte at 16 bits, G <= 16), against the ~20
// FLOPs a byte at which the fp32 CUDA cores would become the limit. So
// tensor cores would not help; the design keeps enough loads in flight
// across the 132 SMs and reads each visible K/V row once:
// - Grid. The host (decode_plan, kernels/flash_attention.py) cuts a lane
//   into chunks of at least 128 keys, a multiple of the page size, from the
//   lane length, the page size and the SM count alone; the serve shapes (8
//   slots, 1 K lanes, 8 or 20 KV heads) give 512 or 1280 blocks, launched
//   chunk by chunk. A block whose chunk holds no visible key returns at
//   once and writes nothing; a live one loads only its keys in [lo, hi):
//   none past pos, none before the window.
// - Every warp on every key. A lane loads 16 bytes of a K row and 16 of
//   the V row (8 bf16/fp16 values, 4 fp32), so a row takes D / 8 lanes (D /
//   4 in fp32) and a warp step 32 / (D / 8) rows, the 4 warps taking
//   interleaved steps. Each of the block's R query rows' dot product is
//   summed over the row's lanes by xor shuffles. Each lane group keeps its
//   own online softmax (m, l, acc) of the R rows in registers, in one pass
//   over K and V together; the groups of a warp merge by shuffles, then the
//   warps through shared memory, in a fixed order.
// - Bytes in flight: a lane issues the K and V loads of U steps (U x 32
//   bytes) before it uses any, and a block is 128 threads, so several live
//   blocks share an SM.
// - G > 8 takes two row groups (blockIdx.x = h * groups + group), each its
//   own block reading the chunk (the second read mostly from L2), so that a
//   lane holds at most 8 rows of q and acc in registers.
// Where the time goes on an H100 at the llama3.2-1b serve shape (each call
// replayed from a CUDA graph after an L2 flush): two launches, and in the
// split kernel a chain of round trips (pos with q and the page ids, then K
// and V) and compute that is not negligible beside its loads. Loads are
// kept in flight in registers, not in a cp.async ring: U = 4, 8 or 16
// steps made no measurable difference, nor did launching chunk by chunk
// rather than chunk fastest; 256 threads a block (fewer blocks an SM) and
// a cap of 128 registers (spills) were slower. What helped: loading q and
// the page ids with pos rather than after it, exp by ex2, and the
// combine's one round of loads.
// The combine (decode_combine_kernel) merges the live chunks' partials in a
// fixed order and writes the output in q's dtype. Nothing is atomic, so two
// calls agree bit for bit; dead chunks are not read, so they need not be
// written. The numerics are the TPU kernels' (see the note at the top),
// with p rounded to the value dtype against the running max.
// Paged and contiguous lanes differ only in where key t's row is: row
// b*S + t of (B*S, KV, D), or row tables[b, t / page] * page + t % page of
// the pages. The rest is the same code, so the paged result equals the
// contiguous one on the gathered lanes bit for bit when both split alike
// (block_k = page_size).

// e^x as ex2.approx of x log2(e), as the tensor-core kernels take it: far
// fewer instructions than expf, and the decode's compute is not negligible
// beside its loads at the serve shapes
__device__ __forceinline__ float exp_fast(float x) { return ex2(x * LOG2E); }

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_MAX_G = 16;
constexpr int COMBINE_THREADS = 256;
constexpr int COMBINE_REGS = 8;   // chunks a combine thread holds in registers

// visible keys [lo, hi) of chunk c from position p; empty when lo >= hi
__device__ __forceinline__ void chunk_keys(int c, int chunk, int p, int win, int kv_len,
                                           int& lo, int& hi) {
  lo = c * chunk;
  hi = min(min(lo + chunk, kv_len), p + 1);
  if (win > 0) lo = max(lo, p - win + 1);
}

// 16 bytes of T -> 16 / sizeof(T) floats
template <typename T> __device__ __forceinline__ void unpack16(const uint4& u, float* f);
template <> __device__ __forceinline__ void unpack16<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
template <> __device__ __forceinline__ void unpack16<__half>(const uint4& u, float* f) {
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __half22float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// R query rows a block (G = 1, 2, 4, or up to 8 per row group); partials
// m/l (B, KV, ns, G), acc (B, KV, ns, G, D) fp32, written for live chunks
template <typename T, int D, int R>
__global__ void __launch_bounds__(DEC_THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ tables, const int* __restrict__ pos,
              float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ acc_out,
              int H, int KV, int S, int NP, int page, int chunk, int kv_len, int win,
              float sm_scale) {
  constexpr int VEC = 16 / sizeof(T);          // values a lane loads at once
  constexpr int LPR = D / VEC;                 // lanes a key row
  constexpr int RPS = 32 / LPR;                // key rows a warp step
  constexpr int KT = DEC_WARPS * RPS;          // keys a block step
  constexpr int U = R >= 8 ? 2 : 8;            // steps whose loads a lane keeps in flight
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "a key row is 2^n lanes of a warp");
  const int G = H / KV, groups = (G + R - 1) / R;
  const int h = blockIdx.x / groups, g0 = (blockIdx.x % groups) * R;
  const int b = blockIdx.y, c = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / LPR, seg = lane % LPR;
  const int c0 = c * chunk;

  extern __shared__ int page_ids[];            // the chunk's physical pages
  __shared__ float sm_m[DEC_WARPS][R], sm_l[DEC_WARPS][R];
  __shared__ float sm_acc[DEC_WARPS][R][D];
  // q and the page ids do not depend on pos: their loads go out with pos's
  if (tables != nullptr) {
    const int n_pages = min(chunk / page, NP - c0 / page);
    for (int i = threadIdx.x; i < n_pages; i += DEC_THREADS)
      page_ids[i] = tables[(size_t)b * NP + c0 / page + i];
  }
  float qv[R][VEC];
#pragma unroll
  for (int g = 0; g < R; ++g) {
    if (g0 + g < G) {
      unpack16<T>(ld16(q + ((size_t)b * H + h * G + g0 + g) * D + seg * VEC), qv[g]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qv[g][i] = 0.f;
    }
  }
  const int p = pos[b];
  int lo, hi;
  chunk_keys(c, chunk, p, win, kv_len, lo, hi);
  if (lo >= hi) return;
  if (tables != nullptr) __syncthreads();

  float m[R], l[R], acc[R][VEC];
#pragma unroll
  for (int g = 0; g < R; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }
  const int s_end = (hi - c0 + KT - 1) / KT;
  for (int s0 = (lo - c0) / KT; s0 < s_end; s0 += U) {
    uint4 kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = c0 + (s0 + u) * KT + warp * RPS + r;
      ok[u] = t >= lo && t < hi;
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      if (ok[u]) {
        const size_t row = tables != nullptr
                               ? (size_t)page_ids[(t - c0) / page] * page + (t - c0) % page
                               : (size_t)b * S + t;
        const size_t off = (row * KV + h) * D + seg * VEC;
        kr[u] = ld16(k + off);
        vr[u] = ld16(v + off);
      }
    }
    float sc[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      unpack16<T>(kr[u], kf);
#pragma unroll
      for (int g = 0; g < R; ++g) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) d += qv[g][i] * kf[i];
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        sc[u][g] = d * sm_scale;
      }
    }
#pragma unroll
    for (int g = 0; g < R; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) mx = fmaxf(mx, sc[u][g]);
      const float alpha = exp_fast(m[g] - mx);
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VEC];
      unpack16<T>(vr[u], vf);
#pragma unroll
      for (int g = 0; g < R; ++g) {
        const float pu = ok[u] ? exp_fast(sc[u][g] - m[g]) : 0.f;
        l[g] += pu;
        const float pr = round_to<T>(pu);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] += pr * vf[i];
      }
    }
  }

  // merge the warp's lane groups (rows of a step), then the warps
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < R; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lother = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mx = fmaxf(m[g], mo);
      const float a = exp_fast(m[g] - mx), a_o = exp_fast(mo - mx);
      l[g] = a * l[g] + a_o * lother;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[g][i] = a * acc[g][i] + a_o * __shfl_xor_sync(0xffffffffu, acc[g][i], o);
      m[g] = mx;
    }
  }
  if (r == 0) {
#pragma unroll
    for (int g = 0; g < R; ++g) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[warp][g][seg * VEC + i] = acc[g][i];
      if (seg == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  const size_t part = ((size_t)b * KV + h) * gridDim.z + c;  // (B, KV, ns) index
  for (int e = threadIdx.x; e < R * D; e += DEC_THREADS) {
    const int g = e / D, d = e % D;
    if (g0 + g >= G) break;
    float M = sm_m[0][g];
#pragma unroll
    for (int w = 1; w < DEC_WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float a = exp_fast(sm_m[w][g] - M);
      L += a * sm_l[w][g];
      A += a * sm_acc[w][g][d];
    }
    acc_out[(part * G + g0 + g) * D + d] = A;
    if (d == 0) {
      m_out[part * G + g0 + g] = M;
      l_out[part * G + g0 + g] = L;
    }
  }
}

// out (B, 1, H, D) in T from the partials of the chunks that hold a key
// visible from pos[b]: one block per (kv head, slot). The live chunks are
// the run [c_first, c_last]. A run of at most COMBINE_REGS chunks is merged
// from registers after one round of loads. A longer one: its m and l go to
// shared memory in one coalesced pass; a warp per query row takes the max
// and turns each m into its weight exp(m - M), and sums l under those
// weights (lanes over chunks, then a shuffle tree: a fixed order); then
// each thread sums its (row, column) of acc over the chunks, 8 loads in
// flight.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
decode_combine_kernel(const float* __restrict__ m, const float* __restrict__ l,
                      const float* __restrict__ acc, const int* __restrict__ pos,
                      T* __restrict__ out, int H, int KV, int D, int chunk, int ns, int kv_len,
                      int win) {
  extern __shared__ float sm[];  // weights [n][G], then l [n][G], then L [G]
  const int G = H / KV, h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = pos[b];
  const int c_first = win > 0 ? max(0, (p - win + 1) / chunk) : 0;
  const int n = p < 0 ? 0 : max(0, min(ns - 1, p / chunk) - c_first + 1);  // the run
  const size_t base = ((size_t)b * KV + h) * ns + c_first;
  if (n <= COMBINE_REGS) {
    // a short run (the serve shapes): each thread loads the m, l and acc of
    // its (row, column) for every chunk at once, and merges in chunk order
    for (int e = threadIdx.x; e < G * D; e += COMBINE_THREADS) {
      const int g = e / D;
      float mc[COMBINE_REGS], lc[COMBINE_REGS], ac[COMBINE_REGS];
#pragma unroll
      for (int c = 0; c < COMBINE_REGS; ++c) {
        int lo = 0, hi = 0;
        if (c < n) chunk_keys(c_first + c, chunk, p, win, kv_len, lo, hi);
        const bool live = lo < hi;
        mc[c] = live ? m[(base + c) * G + g] : NEG_INF;
        lc[c] = live ? l[(base + c) * G + g] : 0.f;
        ac[c] = live ? acc[(base + c) * G * D + e] : 0.f;
      }
      float M = NEG_INF;
#pragma unroll
      for (int c = 0; c < COMBINE_REGS; ++c) M = fmaxf(M, mc[c]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int c = 0; c < COMBINE_REGS; ++c) {
        const float a = mc[c] > NEG_INF ? exp_fast(mc[c] - M) : 0.f;
        L += a * lc[c];
        A += a * ac[c];
      }
      out[((size_t)b * H + h * G) * D + e] = from_f<T>(A / fmaxf(L, 1e-30f));
    }
    return;
  }
  float* w = sm;
  float* lw = sm + (size_t)n * G;
  float* L = lw + (size_t)n * G;
  for (int i = threadIdx.x; i < n * G; i += COMBINE_THREADS) {
    int lo, hi;
    chunk_keys(c_first + i / G, chunk, p, win, kv_len, lo, hi);
    w[i] = lo < hi ? m[base * G + i] : NEG_INF;
    lw[i] = lo < hi ? l[base * G + i] : 0.f;
  }
  __syncthreads();
  for (int g = warp; g < G; g += COMBINE_THREADS / 32) {
    float M = NEG_INF;
    for (int c = lane; c < n; c += 32) M = fmaxf(M, w[c * G + g]);
    M = warp_max(M);
    float s = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float mc = w[c * G + g];
      const float a = mc > NEG_INF ? exp_fast(mc - M) : 0.f;  // 0: a dead chunk's
      w[c * G + g] = a;                                    // acc is never read
      s += a * lw[c * G + g];
    }
    s = warp_sum(s);
    if (lane == 0) L[g] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * D; e += COMBINE_THREADS) {
    const int g = e / D;
    const float* a = acc + base * G * D + e;
    float A = 0.f;
    int c = 0;
    for (; c + 8 <= n; c += 8) {
      float x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = a[(size_t)(c + u) * G * D];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float wt = w[(c + u) * G + g];
        if (wt != 0.f) A += wt * x[u];
      }
    }
    for (; c < n; ++c) {
      const float wt = w[c * G + g];
      if (wt != 0.f) A += wt * a[(size_t)c * G * D];
    }
    out[((size_t)b * H + h * G) * D + e] = from_f<T>(A / fmaxf(L[g], 1e-30f));
  }
}

// dynamic shared memory above 48 KB needs the kernel's opt-in
template <typename F>
cudaError_t allow_smem(F kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DK, int DV>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                       const void* q_off, int B, int Sq, int Sk, int H, int KV, int win,
                       float sm_scale, cudaStream_t stream) {
  const int G = H / KV;
  const int block_q = FWD_ROWS / G;
  const size_t smem = sizeof(float) * (FWD_ROWS * DK + FWD_BK * (DK + KPAD) + FWD_BK * DV +
                                       FWD_ROWS * FWD_BK);
  auto kern = fwd_kernel<T, DK, DV>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + block_q - 1) / block_q, KV, B);
  kern<<<grid, FWD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), static_cast<const int*>(q_off), Sq, Sk, H,
      KV, block_q, win, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D, int R>
cudaError_t launch_decode_rows(const void* q, const void* k, const void* v, const void* tables,
                               const void* pos, void* m, void* l, void* acc, int B, int H,
                               int KV, int S, int NP, int page, int chunk, int ns, int kv_len,
                               int win, float sm_scale, cudaStream_t stream) {
  const int groups = (H / KV + R - 1) / R;
  const size_t smem = tables != nullptr ? sizeof(int) * ((chunk + page - 1) / page) : 0;
  auto kern = decode_kernel<T, D, R>;
  if (smem > 16 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  // chunk slowest: every slot's first chunks, the live ones, start first
  dim3 grid(KV * groups, B, ns);
  kern<<<grid, DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(tables), static_cast<const int*>(pos), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(acc), H, KV, S, NP, page, chunk, kv_len, win,
      sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const void* tables,
                          const void* pos, void* m, void* l, void* acc, int B, int H, int KV,
                          int S, int NP, int page, int chunk, int ns, int kv_len, int win,
                          float sm_scale, cudaStream_t s) {
  const int G = H / KV;
  if (G == 1)
    return launch_decode_rows<T, D, 1>(q, k, v, tables, pos, m, l, acc, B, H, KV, S, NP, page, chunk, ns, kv_len, win, sm_scale, s);
  if (G == 2)
    return launch_decode_rows<T, D, 2>(q, k, v, tables, pos, m, l, acc, B, H, KV, S, NP, page, chunk, ns, kv_len, win, sm_scale, s);
  if (G <= 4)
    return launch_decode_rows<T, D, 4>(q, k, v, tables, pos, m, l, acc, B, H, KV, S, NP, page, chunk, ns, kv_len, win, sm_scale, s);
  return launch_decode_rows<T, D, 8>(q, k, v, tables, pos, m, l, acc, B, H, KV, S, NP, page, chunk, ns, kv_len, win, sm_scale, s);
}

template <typename T>
cudaError_t launch_combine(const void* m, const void* l, const void* acc, const void* pos,
                           void* out, int B, int H, int KV, int D, int chunk, int ns, int kv_len,
                           int win, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * ns * (H / KV) + H / KV);
  auto kern = decode_combine_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(KV, B);
  kern<<<grid, COMBINE_THREADS, smem, stream>>>(
      static_cast<const float*>(m), static_cast<const float*>(l), static_cast<const float*>(acc),
      static_cast<const int*>(pos), static_cast<T*>(out), H, KV, D, chunk, ns, kv_len, win);
  return cudaGetLastError();
}

template <typename T, int DK, int DV>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* di, void* dq, const void* q_off, int B,
                          int Sq, int Sk, int H, int KV, int win, float sm_scale,
                          cudaStream_t stream) {
  const int block_q = DQ_ROWS / (H / KV);
  const size_t smem = sizeof(float) * (DQ_ROWS * (DK + DV) + BWD_BK * (DK + DV + 2 * KPAD) +
                                       DQ_ROWS * BWD_BK + 2 * DQ_ROWS);
  auto kern = bwd_dq_kernel<T, DK, DV>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + block_q - 1) / block_q, KV, B);
  kern<<<grid, DQ_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dq), static_cast<const int*>(q_off), Sq, Sk, H, KV, block_q, win, sm_scale);
  return cudaGetLastError();
}

template <typename T, int DK, int DV>
cudaError_t launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* di, void* dk, void* dv, const void* q_off,
                           int B, int Sq, int Sk, int H, int KV, int win, float sm_scale,
                           cudaStream_t stream) {
  using Sh = DkvShape<DK, DV>;
  const int block_q = Sh::ROWS / (H / KV);
  const size_t smem = sizeof(float) * (BWD_BK * (DK + DV + 2 * KPAD) + Sh::ROWS * (DK + DV) +
                                       2 * Sh::ROWS * BWD_BK + 2 * Sh::ROWS);
  auto kern = bwd_dkv_kernel<T, DK, DV>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sk + BWD_BK - 1) / BWD_BK, KV, B);
  kern<<<grid, Sh::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<const int*>(q_off), Sq, Sk, H, KV,
      block_q, win, sm_scale);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, reached through the runtime so
// the library needs no -lcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got) ==
            cudaSuccess &&
        got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (B, S, N, D) tensor of 16-bit values as the 4-D map (D, N, S, B) with
// boxes of (pcols, n_box, s_box, 1), one a panel of pcols values (rows of
// 128 bytes take TMA's 128-byte swizzle, of 64 the 64-byte one), swizzled
// as the wgmma descriptors read them; elements past S are zero-filled
template <typename T>
cudaError_t panel_map(CUtensorMap* map, const void* base, int B, int S, int N, int D, int pcols,
                      int n_box, int s_box) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)N * D * 2,
                                 (cuuint64_t)S * N * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)pcols, (cuuint32_t)n_box, (cuuint32_t)s_box, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      pcols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the panels of Tile<D>
template <typename T, int D>
cudaError_t row_map(CUtensorMap* map, const void* base, int B, int S, int N, int n_box,
                    int s_box) {
  return panel_map<T>(map, base, B, S, N, D, Tile<D>::PCOLS, n_box, s_box);
}

// the MLA route's backward on the tensor cores: dq straight into its
// output; dk/dv as fp32 partials of `chunk` q tiles into `part`, summed by
// launch_mla_dkv_reduce (a launch of its own)
template <typename T, int DK, int DV>
cudaError_t launch_bwd_dq_mla(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* di, void* dq, const void* q_off,
                              int B, int Sq, int Sk, int H, int KV, int win, float sm_scale,
                              cudaStream_t stream) {
  const int G = H / KV, block_q = HB_M / G;
  CUtensorMap mq, mdo, mk, mv;
  cudaError_t e;
  if ((e = panel_map<T>(&mq, q, B, Sq, H, DK, 64, G, block_q)) != cudaSuccess ||
      (e = panel_map<T>(&mdo, dout, B, Sq, H, DV, 64, G, block_q)) != cudaSuccess ||
      (e = panel_map<T>(&mk, k, B, Sk, KV, DK, 64, 1, MB_N)) != cudaSuccess ||
      (e = panel_map<T>(&mv, v, B, Sk, KV, DV, 64, 1, MB_N)) != cudaSuccess)
    return e;
  constexpr int smem = MlaBwd<DK, DV>::SMEM;
  auto kern = bwd_dq_mla_hopper<T, DK, DV>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int nq = (Sq + block_q - 1) / block_q;
  kern<<<nq * KV * B, MB_THREADS, smem, stream>>>(
      mq, mdo, mk, mv, static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dq), static_cast<const int*>(q_off), B, Sq, Sk, H, KV, win, sm_scale);
  return cudaGetLastError();
}

template <typename T, int DK, int DV>
cudaError_t launch_bwd_dkv_mla(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* di, void* part, const void* q_off,
                               int B, int Sq, int Sk, int H, int KV, int win, float sm_scale,
                               int chunk, cudaStream_t stream) {
  const int G = H / KV, block_q = MB_N / G;
  if (part == nullptr || chunk <= 0) return cudaErrorInvalidValue;
  CUtensorMap mk, mv, mq, mdo;
  cudaError_t e;
  if ((e = panel_map<T>(&mk, k, B, Sk, KV, DK, 64, 1, HB_M)) != cudaSuccess ||
      (e = panel_map<T>(&mv, v, B, Sk, KV, DV, 64, 1, HB_M)) != cudaSuccess ||
      (e = panel_map<T>(&mq, q, B, Sq, H, DK, 64, G, block_q)) != cudaSuccess ||
      (e = panel_map<T>(&mdo, dout, B, Sq, H, DV, 64, G, block_q)) != cudaSuccess)
    return e;
  constexpr int smem = MlaBwd<DK, DV>::SMEM;
  auto kern = bwd_dkv_mla_hopper<T, DK, DV>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int nq = (Sq + block_q - 1) / block_q, nk = (Sk + HB_M - 1) / HB_M;
  const int n_chunks = (nq + chunk - 1) / chunk;
  kern<<<n_chunks * 2 * nk * KV * B, MB_THREADS, smem, stream>>>(
      mk, mv, mq, mdo, static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<float*>(part), static_cast<const int*>(q_off), B, Sq, Sk, H, KV, win, sm_scale,
      chunk);
  return cudaGetLastError();
}

template <typename T, int DK, int DV>
cudaError_t launch_mla_dkv_reduce(const void* part, void* dk, void* dv, const void* q_off, int B,
                                  int Sq, int Sk, int H, int KV, int win, int chunk,
                                  cudaStream_t stream) {
  if (part == nullptr || chunk <= 0) return cudaErrorInvalidValue;
  mla_dkv_reduce<T, DK, DV><<<B * Sk * KV, MR_THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<const int*>(q_off), B, Sq, Sk, H, KV, win, chunk);
  return cudaGetLastError();
}

// the MLA route's forward on the tensor cores: q tiles of 64 rows, key
// tiles of 32 keys, each in panels of 64 values
template <typename T, int DK, int DV>
cudaError_t launch_fwd_mla(const void* q, const void* k, const void* v, void* out, void* lse,
                           const void* q_off, int B, int Sq, int Sk, int H, int KV, int win,
                           float sm_scale, cudaStream_t stream) {
  const int G = H / KV, block_q = HB_M / G;
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = panel_map<T>(&mq, q, B, Sq, H, DK, 64, G, block_q)) != cudaSuccess ||
      (e = panel_map<T>(&mk, k, B, Sk, KV, DK, 64, 1, MB_N)) != cudaSuccess ||
      (e = panel_map<T>(&mv, v, B, Sk, KV, DV, 64, 1, MB_N)) != cudaSuccess)
    return e;
  constexpr int smem = MlaFwd<DK, DV>::SMEM;
  auto kern = fwd_mla_hopper<T, DK, DV>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int nq = (Sq + block_q - 1) / block_q;
  kern<<<nq * KV * B, MB_THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<T*>(out), static_cast<float*>(lse),
      static_cast<const int*>(q_off), B, Sq, Sk, H, KV, win, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_hopper(bool dq_pass, const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, const void* di, void* o1,
                              void* o2, const void* q_off, int B, int Sq, int Sk, int H, int KV,
                              int win, float sm_scale, cudaStream_t stream) {
  const int block_q = HB_M / (H / KV);
  CUtensorMap mq, mdo, mk, mv;
  cudaError_t e;
  if ((e = row_map<T, D>(&mq, q, B, Sq, H, H / KV, block_q)) != cudaSuccess ||
      (e = row_map<T, D>(&mdo, dout, B, Sq, H, H / KV, block_q)) != cudaSuccess ||
      (e = row_map<T, D>(&mk, k, B, Sk, KV, 1, HB_M)) != cudaSuccess ||
      (e = row_map<T, D>(&mv, v, B, Sk, KV, 1, HB_M)) != cudaSuccess)
    return e;
  // six 64-row tiles, dk/dv's lse/di stages, 3 mbarriers, 1024-byte alignment
  const int smem = 6 * Tile<D>::BYTES + 4 * HB_M * 4 + 64 + 1024;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  const int* qo = static_cast<const int*>(q_off);
  if (dq_pass) {
    auto kern = bwd_dq_hopper<T, D>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const int nq = (Sq + block_q - 1) / block_q;
    kern<<<nq * KV * B, HB_THREADS, smem, stream>>>(mq, mdo, mk, mv, l, d, static_cast<T*>(o1),
                                                     qo, B, Sq, Sk, H, KV, win, sm_scale);
  } else {
    auto kern = bwd_dkv_hopper<T, D>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const int nk = (Sk + HB_M - 1) / HB_M;
    kern<<<nk * KV * B, HB_THREADS, smem, stream>>>(mq, mdo, mk, mv, l, d, static_cast<T*>(o1),
                                                     static_cast<T*>(o2), qo, B, Sq, Sk, H, KV,
                                                     win, sm_scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_fwd_hopper(const void* q, const void* k, const void* v, void* out, void* lse,
                              const void* q_off, int B, int Sq, int Sk, int H, int KV, int win,
                              float sm_scale, cudaStream_t stream) {
  const int G = H / KV, block_q = HB_M / G;
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = row_map<T, D>(&mq, q, B, Sq, H, G, block_q)) != cudaSuccess ||
      (e = row_map<T, D>(&mk, k, B, Sk, KV, 1, HB_M)) != cudaSuccess ||
      (e = row_map<T, D>(&mv, v, B, Sk, KV, 1, HB_M)) != cudaSuccess)
    return e;
  // Q, the K/V ring, the mbarriers, 1024-byte alignment
  constexpr int ST = FWD_STAGES;
  const int smem = (1 + 2 * ST) * Tile<D>::BYTES + 8 * (1 + ST) + 1024;
  auto kern = fwd_hopper<T, D>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int nq = (Sq + block_q - 1) / block_q;
  kern<<<nq * KV * B, HB_THREADS, smem, stream>>>(mq, mk, mv, static_cast<T*>(out),
                                                   static_cast<float*>(lse),
                                                   static_cast<const int*>(q_off), B, Sq, Sk, H,
                                                   KV, win, sm_scale);
  return cudaGetLastError();
}

// fp32 on the CUDA cores, bf16/fp16 on the tensor cores (see the note at
// the top); nothing falls back from one path to the other
template <int D>
cudaError_t bwd_by_dtype(int dtype, bool dq_pass, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* di, void* o1, void* o2,
                         const void* q_off, int B, int Sq, int Sk, int H, int KV, int win,
                         float sm_scale, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return dq_pass ? launch_bwd_dq<float, D, D>(q, k, v, dout, lse, di, o1, q_off, B, Sq, Sk, H,
                                                  KV, win, sm_scale, s)
                     : launch_bwd_dkv<float, D, D>(q, k, v, dout, lse, di, o1, o2, q_off, B, Sq,
                                                   Sk, H, KV, win, sm_scale, s);
    case 1:
      return launch_bwd_hopper<__nv_bfloat16, D>(dq_pass, q, k, v, dout, lse, di, o1, o2, q_off,
                                                 B, Sq, Sk, H, KV, win, sm_scale, s);
    case 2:
      return launch_bwd_hopper<__half, D>(dq_pass, q, k, v, dout, lse, di, o1, o2, q_off, B, Sq,
                                          Sk, H, KV, win, sm_scale, s);
  }
  return cudaErrorInvalidValue;
}

// largest G = H / KV: a 64-row tile on the tensor cores, 16 rows in fp32
int max_group(int dtype) { return dtype == 0 ? DQ_ROWS : HB_M; }

int bwd_entry(bool dq_pass, const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* di, void* o1, void* o2, const void* q_off, int B,
              int Sq, int Sk, int H, int KV, int D, int dtype, int window, float sm_scale,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || H / KV > max_group(dtype) || B <= 0 || Sq <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  if (D == 32) return bwd_by_dtype<32>(dtype, dq_pass, q, k, v, dout, lse, di, o1, o2, q_off, B, Sq, Sk, H, KV, window, sm_scale, s);
  if (D == 64) return bwd_by_dtype<64>(dtype, dq_pass, q, k, v, dout, lse, di, o1, o2, q_off, B, Sq, Sk, H, KV, window, sm_scale, s);
  if (D == 128) return bwd_by_dtype<128>(dtype, dq_pass, q, k, v, dout, lse, di, o1, o2, q_off, B, Sq, Sk, H, KV, window, sm_scale, s);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t fwd_by_dtype(int dtype, const void* q, const void* k, const void* v, void* out,
                         void* lse, const void* q_off, int B, int Sq, int Sk, int H, int KV,
                         int win, float sm_scale, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_fwd<float, D, D>(q, k, v, out, lse, q_off, B, Sq, Sk, H, KV, win, sm_scale, s);
    case 1: return launch_fwd_hopper<__nv_bfloat16, D>(q, k, v, out, lse, q_off, B, Sq, Sk, H, KV, win, sm_scale, s);
    case 2: return launch_fwd_hopper<__half, D>(q, k, v, out, lse, q_off, B, Sq, Sk, H, KV, win, sm_scale, s);
  }
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t decode_by_dtype(int dtype, const void* q, const void* k, const void* v,
                            const void* tables, const void* pos, void* m, void* l, void* acc,
                            int B, int H, int KV, int S, int NP, int page, int chunk, int ns,
                            int kv_len, int win, float sm_scale, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_decode<float, D>(q, k, v, tables, pos, m, l, acc, B, H, KV, S, NP, page, chunk, ns, kv_len, win, sm_scale, s);
    case 1: return launch_decode<__nv_bfloat16, D>(q, k, v, tables, pos, m, l, acc, B, H, KV, S, NP, page, chunk, ns, kv_len, win, sm_scale, s);
    case 2: return launch_decode<__half, D>(q, k, v, tables, pos, m, l, acc, B, H, KV, S, NP, page, chunk, ns, kv_len, win, sm_scale, s);
  }
  return cudaErrorInvalidValue;
}

// The MLA route at a built (DK, DV) pair, in the input's type: the forward
// and the backward on the CUDA cores in fp32 (its 1e-5 checks are out of
// TF32's reach), on the tensor cores in bf16/fp16, built at (MLA_TC_DK,
// MLA_TC_DV) alone (the wrapper pads the other pairs up to it). which: 0
// forward (o1 = out, o2 = lse), 1 dq (o1), 2 dk/dv (fp32: o1 = dk, o2 =
// dv; bf16/fp16: the partials into part), 3 the bf16/fp16 dk/dv reduction
// (part into o1 = dk, o2 = dv). Nothing falls back from one route to the
// other.
template <typename T, int DK, int DV>
cudaError_t mla_launch(int which, const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* di, void* o1, void* o2, const void* q_off,
                       int B, int Sq, int Sk, int H, int KV, int win, float sm_scale,
                       void* part, int chunk, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    if (which == 0)
      return launch_fwd<T, DK, DV>(q, k, v, o1, o2, q_off, B, Sq, Sk, H, KV, win, sm_scale, s);
    if (which == 1)
      return launch_bwd_dq<T, DK, DV>(q, k, v, dout, lse, di, o1, q_off, B, Sq, Sk, H, KV, win, sm_scale, s);
    if (which == 2)
      return launch_bwd_dkv<T, DK, DV>(q, k, v, dout, lse, di, o1, o2, q_off, B, Sq, Sk, H, KV, win, sm_scale, s);
  } else if constexpr (DK == MLA_TC_DK && DV == MLA_TC_DV) {
    if (which == 0)
      return launch_fwd_mla<T, DK, DV>(q, k, v, o1, o2, q_off, B, Sq, Sk, H, KV, win, sm_scale, s);
    if (which == 1)
      return launch_bwd_dq_mla<T, DK, DV>(q, k, v, dout, lse, di, o1, q_off, B, Sq, Sk, H, KV, win, sm_scale, s);
    if (which == 2)
      return launch_bwd_dkv_mla<T, DK, DV>(q, k, v, dout, lse, di, part, q_off, B, Sq, Sk, H, KV, win, sm_scale, chunk, s);
    if (which == 3)
      return launch_mla_dkv_reduce<T, DK, DV>(part, o1, o2, q_off, B, Sq, Sk, H, KV, win, chunk, s);
  }
  return cudaErrorInvalidValue;
}

template <int DK, int DV>
cudaError_t mla_by_dtype(int dtype, int which, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* di, void* o1, void* o2,
                         const void* q_off, int B, int Sq, int Sk, int H, int KV, int win,
                         float sm_scale, void* part, int chunk, cudaStream_t s) {
  switch (dtype) {
    case 0: return mla_launch<float, DK, DV>(which, q, k, v, dout, lse, di, o1, o2, q_off, B, Sq, Sk, H, KV, win, sm_scale, part, chunk, s);
    case 1: return mla_launch<__nv_bfloat16, DK, DV>(which, q, k, v, dout, lse, di, o1, o2, q_off, B, Sq, Sk, H, KV, win, sm_scale, part, chunk, s);
    case 2: return mla_launch<__half, DK, DV>(which, q, k, v, dout, lse, di, o1, o2, q_off, B, Sq, Sk, H, KV, win, sm_scale, part, chunk, s);
  }
  return cudaErrorInvalidValue;
}

int mla_entry(int which, const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* di, void* o1, void* o2, const void* q_off, int B,
              int Sq, int Sk, int H, int KV, int Dk, int Dv, int dtype, int window,
              float sm_scale, void* part, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || H / KV > CC_MAX_G || B <= 0 || Sq <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  if (Dk == 96 && Dv == 64)
    return mla_by_dtype<96, 64>(dtype, which, q, k, v, dout, lse, di, o1, o2, q_off, B, Sq, Sk, H, KV, window, sm_scale, part, chunk, s);
  if (Dk == 576 && Dv == 512)
    return mla_by_dtype<576, 512>(dtype, which, q, k, v, dout, lse, di, o1, o2, q_off, B, Sq, Sk, H, KV, window, sm_scale, part, chunk, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k/v (B, Sk, KV, D), q_off (B,) int32 on the device;
// out (B, Sq, H, D) in the input dtype, lse (B, Sq, H) fp32 or NULL.
// dtype: 0 float32, 1 bfloat16, 2 float16. D: 32, 64 or 128. bf16/fp16
// (tensor cores): G = H/KV <= 64, a block holds (64 / G) queries of G heads
// each; fp32: G <= 16, (16 / G) queries; the spare rows idle.
int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
              const void* q_off, int B, int Sq, int Sk, int H, int KV, int D, int dtype,
              int window, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || H / KV > max_group(dtype) || B <= 0 || Sq <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  if (D == 32) return fwd_by_dtype<32>(dtype, q, k, v, out, lse, q_off, B, Sq, Sk, H, KV, window, sm_scale, s);
  if (D == 64) return fwd_by_dtype<64>(dtype, q, k, v, out, lse, q_off, B, Sq, Sk, H, KV, window, sm_scale, s);
  if (D == 128) return fwd_by_dtype<128>(dtype, q, k, v, out, lse, q_off, B, Sq, Sk, H, KV, window, sm_scale, s);
  return cudaErrorInvalidValue;
}

// Backward of flash_fwd. q/dout (B, Sq, H, D), k/v (B, Sk, KV, D) in one
// dtype; lse and di = rowsum(out * dout) (B, Sq, H) fp32; q_off (B,) int32.
// dq (B, Sq, H, D); dk/dv (B, Sk, KV, D), summed over the G heads of a group.
// D 32, 64 or 128. bf16/fp16 (tensor cores): G = H/KV <= 64, q tiles of
// (64 / G) * G rows, key tiles of 64; fp32: G <= 16, (16 / G) * G rows (dq)
// and (32 / G) * G (dk/dv).
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
// paged: k/v (P, page, KV, D), tables (B, NP) int32, S unused. pos (B,)
// int32. Lanes of kv_len keys in ns chunks of `chunk` keys (a multiple of
// `page`). Partials m/l (B, KV, ns, G) and acc (B, KV, ns, G, D) fp32,
// written only for chunks that hold a visible key. D 32, 64 or 128; G =
// H/KV <= 16; q, k, v 16-byte aligned.
int flash_decode_split(const void* q, const void* k, const void* v, const void* tables,
                       const void* pos, void* m, void* l, void* acc, int B, int H, int KV,
                       int D, int dtype, int S, int NP, int page, int chunk, int ns, int kv_len,
                       int window, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || H / KV > DEC_MAX_G || B <= 0 || page <= 0 || chunk <= 0 ||
      chunk % page != 0 || ns <= 0 || (long long)ns * chunk < kv_len)
    return cudaErrorInvalidValue;
  if (D == 32) return decode_by_dtype<32>(dtype, q, k, v, tables, pos, m, l, acc, B, H, KV, S, NP, page, chunk, ns, kv_len, window, sm_scale, s);
  if (D == 64) return decode_by_dtype<64>(dtype, q, k, v, tables, pos, m, l, acc, B, H, KV, S, NP, page, chunk, ns, kv_len, window, sm_scale, s);
  if (D == 128) return decode_by_dtype<128>(dtype, q, k, v, tables, pos, m, l, acc, B, H, KV, S, NP, page, chunk, ns, kv_len, window, sm_scale, s);
  return cudaErrorInvalidValue;
}

// The merge of flash_decode_split's partials (layouts as there) over the
// chunks that hold a key visible from pos (B,): out (B, 1, H, D) in dtype.
int flash_decode_combine(const void* m, const void* l, const void* acc, const void* pos,
                         void* out, int B, int H, int KV, int D, int dtype, int chunk, int ns,
                         int kv_len, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || B <= 0 || D <= 0 || chunk <= 0 || ns <= 0)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch_combine<float>(m, l, acc, pos, out, B, H, KV, D, chunk, ns, kv_len, window, s);
    case 1: return launch_combine<__nv_bfloat16>(m, l, acc, pos, out, B, H, KV, D, chunk, ns, kv_len, window, s);
    case 2: return launch_combine<__half>(m, l, acc, pos, out, B, H, KV, D, chunk, ns, kv_len, window, s);
  }
  return cudaErrorInvalidValue;
}

// The MLA route: q (B, Sq, H, Dk), k (B, Sk, KV, Dk), v (B, Sk, KV, Dv),
// G = H/KV <= 16; fp32 at either built pair, (96, 64) or (576, 512), on
// the CUDA cores, bf16/fp16 at (576, 512) on the tensor cores (16-byte
// aligned, contiguous q, k, v, dout). flash_mla_fwd: out (B, Sq, H, Dv),
// lse (B, Sq, H) fp32 or NULL. The backward as flash_bwd_dq/dkv with dout
// (B, Sq, H, Dv): dq (B, Sq, H, Dk), dk (B, Sk, KV, Dk), dv (B, Sk, KV,
// Dv); in fp32 flash_mla_bwd_dkv writes dk and dv (part NULL, chunk 0), in
// bf16/fp16 it writes fp32 partials of `chunk` q
// tiles of 32 rows into part (n_chunks x B x Sk x KV x (Dk + Dv) floats,
// n_chunks = ceil(ceil(Sq / (32 / G)) / chunk)) and flash_mla_dkv_reduce
// sums them into dk and dv.
int flash_mla_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                  const void* q_off, int B, int Sq, int Sk, int H, int KV, int Dk, int Dv,
                  int dtype, int window, float sm_scale, void* stream) {
  return mla_entry(0, q, k, v, nullptr, nullptr, nullptr, out, lse, q_off, B, Sq, Sk, H, KV, Dk,
                   Dv, dtype, window, sm_scale, nullptr, 0, stream);
}

int flash_mla_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* di, void* dq, const void* q_off, int B, int Sq,
                     int Sk, int H, int KV, int Dk, int Dv, int dtype, int window, float sm_scale,
                     void* stream) {
  return mla_entry(1, q, k, v, dout, lse, di, dq, nullptr, q_off, B, Sq, Sk, H, KV, Dk, Dv,
                   dtype, window, sm_scale, nullptr, 0, stream);
}

int flash_mla_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* di, void* dk, void* dv, const void* q_off,
                      int B, int Sq, int Sk, int H, int KV, int Dk, int Dv, int dtype,
                      int window, float sm_scale, void* part, int chunk, void* stream) {
  return mla_entry(2, q, k, v, dout, lse, di, dk, dv, q_off, B, Sq, Sk, H, KV, Dk, Dv, dtype,
                   window, sm_scale, part, chunk, stream);
}

int flash_mla_dkv_reduce(const void* part, void* dk, void* dv, const void* q_off, int B, int Sq,
                         int Sk, int H, int KV, int Dk, int Dv, int dtype, int window, int chunk,
                         void* stream) {
  return mla_entry(3, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, dk, dv, q_off, B, Sq,
                   Sk, H, KV, Dk, Dv, dtype, window, 0.f, const_cast<void*>(part), chunk, stream);
}

}  // extern "C"
