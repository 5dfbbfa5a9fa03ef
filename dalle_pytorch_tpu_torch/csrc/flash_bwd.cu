// Block-sparse flash-attention backward for any boolean attention pattern.
//
// Replaces the two TPU backward kernels of
// dalle_pytorch_tpu/ops/attention_pallas.py (both launched by `_call_bwd`):
//
//   flash_bwd_dq   <- `_bwd_dq_kernel`    dq
//   flash_bwd_dkv  <- `_bwd_dkv_kernel`   dk and dv
//
// From the forward's inputs, its saved lse and delta = rowsum(do * o)
// (computed by the caller in f32, as `_flash_bwd` does outside its kernels):
//
//   s   = (q . k^T) * scale + bias[key]          f32, per (row, key)
//   s   = mask[row, key] ? s : NEG_INF           NEG_INF = -1e30 (finite)
//   p   = s <= NEG_INF / 2 ? 0 : exp(s - lse)    0 on rows with lse = +inf
//   dp  = do . v^T
//   ds  = p * (dp - delta)
//   dq  = ds . k * scale
//   dk  = ds^T . q * scale
//   dv  = p^T . do
//
// Layout as in flash_fwd.cu: q, k, v, do and the outputs are [bh, n, 64]
// contiguous (bh = batch * heads) in f32 or bf16, outputs in the input
// type; lse and delta are [bh, n] f32; mask is the forward's [n, n] uint8
// and bsum its [ceil(n/BQ), ceil(n/BK)] int32 tile summary; bias is the
// optional additive key-pad bias [b, n] f32 (nullptr for none).  n needs no
// padding: query rows >= n add nothing to dk/dv and keys >= n nothing to
// dq, because every pair outside [0, n)^2 gets p = 0.
//
// What bounds them on an H100.  At the train step's shape (b 16, 8 heads,
// n 1104, bf16) the dense `full` pattern's live pairs cost about 30 GFLOP
// for dq (6 * 64 flop per pair) and 40 GFLOP for dk/dv (8 * 64): some 30
// and 40 us at the bf16 tensor-core peak.  The sparse patterns need a
// sixth of that and are bound by the bytes instead: q, k, v and do read
// once and the outputs written once, 18 MB each, about 28 us (dq) and
// 33 us (dk/dv) at 3.35 TB/s.  So every pattern sits within a few tens of
// microseconds of both roofs at once; this version, all f32 FMA on the
// CUDA cores, reaches neither (PERF.md has its times).
//
// What the design does about it.  The TPU kernels keep the whole
// sequence's K/V (dq) or Q/dO (dk/dv) resident in VMEM per program.  A
// Hopper block has at most 227 KB of shared memory and many blocks must be
// in flight, so here tiles stream through shared memory instead:
//
// * flash_bwd_dq: one block per (bh, 64-row q tile), two threads per query
//   row.  The block stages its do tile once; each live 32-key tile of K and
//   V is then staged as f32.  A thread holds its row of q in registers,
//   computes s and dp for its half of the tile's keys, and accumulates half
//   of the row's dq columns, taking the partner's ds through one warp
//   shuffle per key.
// * flash_bwd_dkv: one block per (bh, 32-key tile), two threads per key.
//   A thread holds its key's row of k in registers and the block's V tile
//   sits in shared memory; the block walks the live q tiles of its bsum
//   column, staging each in 32-row chunks of q, do, lse and delta, and
//   accumulates half of dk's and dv's columns for its key.  Each block
//   owns its keys' outputs, so there are no atomics and every run gives
//   the same bits.
//
// Both skip dead tiles by bsum and apply the element mask inside live ones,
// so the `sparse` variant's 16-wide random blocks stay exact.  Tensor cores
// (wgmma) and TMA staging are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;        // head dim
constexpr int BQ = 64;        // query rows per tile (the forward's)
constexpr int BK = 32;        // keys per tile (the forward's)
constexpr int PAD = DH + 1;   // shared-memory row stride (bank spread)
constexpr int CH = DH / 2;    // output columns per thread
constexpr float NEG_INF = -1e30f;

// flash_bwd_dq: two threads per query row
constexpr int DQ_THREADS = 2 * BQ;
constexpr int KH = BK / 2;    // keys per thread per k tile

// flash_bwd_dkv: two threads per key, q tiles taken in chunks of QC rows
constexpr int DKV_THREADS = 2 * BK;
constexpr int QC = 32;
constexpr int QH = QC / 2;    // query rows per thread per chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p of one (row, key) pair from its raw score q.k: scaled, biased, masked.
__device__ __forceinline__ float prob(float dot, float scale, float bias,
                                      bool allowed, float lse) {
  const float x = dot * scale + bias;
  return (allowed && x > NEG_INF * 0.5f) ? expf(x - lse) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(DQ_THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ mask,
                    const int32_t* __restrict__ bsum,
                    const float* __restrict__ bias, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int n, int heads, int nk_tiles, float scale) {
  __shared__ float ks[BK][PAD];
  __shared__ float vs[BK][PAD];
  __shared__ float dos[BQ][PAD];

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid >> 1;   // query row within the tile
  const int hh = tid & 1;   // which half of the keys / output columns
  const int q0 = qt * BQ;
  const int row = q0 + r;
  const bool row_ok = row < n;
  const size_t base = (size_t)bh * n * DH;

  for (int e = tid; e < BQ * DH; e += DQ_THREADS) {
    const int i = e / DH, d = e % DH;
    dos[i][d] = q0 + i < n ? to_f32(dout[base + (size_t)(q0 + i) * DH + d])
                           : 0.f;
  }
  float qr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d)
    qr[d] = row_ok ? to_f32(q[base + (size_t)row * DH + d]) : 0.f;
  float acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = 0.f;

  const float lse_r = row_ok ? lse[(size_t)bh * n + row] : INFINITY;
  const float delta_r = row_ok ? delta[(size_t)bh * n + row] : 0.f;
  const float* brow = bias ? bias + (size_t)(bh / heads) * n : nullptr;
  const uint8_t* mrow = mask + (size_t)(row_ok ? row : 0) * n;
  const int32_t* brow_sum = bsum + (size_t)qt * nk_tiles;

  for (int kt = 0; kt < nk_tiles; ++kt) {
    if (brow_sum[kt] == 0) continue;  // the same for the whole block
    const int k0 = kt * BK;
    __syncthreads();  // the do tile is staged; the last tile's readers done
    for (int e = tid; e < BK * DH; e += DQ_THREADS) {
      const int j = e / DH, d = e % DH;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < n) {
        kv = to_f32(k[base + (size_t)key * DH + d]);
        vv = to_f32(v[base + (size_t)key * DH + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    float s[KH], dp[KH];
#pragma unroll
    for (int jj = 0; jj < KH; ++jj) s[jj] = dp[jj] = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      const float qd = qr[d];
      const float od = dos[r][d];
#pragma unroll
      for (int jj = 0; jj < KH; ++jj) {
        s[jj] = fmaf(qd, ks[hh * KH + jj][d], s[jj]);
        dp[jj] = fmaf(od, vs[hh * KH + jj][d], dp[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < KH; ++jj) {
      const int key = k0 + hh * KH + jj;
      const bool ok = row_ok && key < n && mrow[key] != 0;
      const float b = (ok && brow) ? brow[key] : 0.f;
      s[jj] = prob(s[jj], scale, b, ok, lse_r) * (dp[jj] - delta_r);  // ds
    }
#pragma unroll
    for (int jj = 0; jj < KH; ++jj) {
      // the partner thread holds the other half of this row's keys
      const float ds_mine = s[jj];
      const float ds_other = __shfl_xor_sync(0xffffffffu, ds_mine, 1);
      const float* k_mine = &ks[hh * KH + jj][hh * CH];
      const float* k_other = &ks[(1 - hh) * KH + jj][hh * CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        acc[c] = fmaf(ds_mine, k_mine[c], acc[c]);
        acc[c] = fmaf(ds_other, k_other[c], acc[c]);
      }
    }
  }

  if (row_ok) {
    T* out = dq + base + (size_t)row * DH + hh * CH;
#pragma unroll
    for (int c = 0; c < CH; ++c) out[c] = from_f32<T>(acc[c] * scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(DKV_THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ mask,
                     const int32_t* __restrict__ bsum,
                     const float* __restrict__ bias,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int n, int heads, int nq_tiles,
                     int nk_tiles, float scale) {
  __shared__ float qs[QC][PAD];
  __shared__ float dos[QC][PAD];
  __shared__ float vs[BK][PAD];
  __shared__ float lse_s[QC];
  __shared__ float delta_s[QC];

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid >> 1;   // key within the tile
  const int hh = tid & 1;   // which half of the rows / output columns
  const int k0 = kt * BK;
  const int key = k0 + r;
  const bool key_ok = key < n;
  const size_t base = (size_t)bh * n * DH;

  for (int e = tid; e < BK * DH; e += DKV_THREADS) {
    const int j = e / DH, d = e % DH;
    vs[j][d] = k0 + j < n ? to_f32(v[base + (size_t)(k0 + j) * DH + d]) : 0.f;
  }
  float kr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d)
    kr[d] = key_ok ? to_f32(k[base + (size_t)key * DH + d]) : 0.f;
  float dk_acc[CH], dv_acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  const float kbias =
      (bias && key_ok) ? bias[(size_t)(bh / heads) * n + key] : 0.f;

  for (int qt = 0; qt < nq_tiles; ++qt) {
    if (bsum[(size_t)qt * nk_tiles + kt] == 0) continue;  // block-uniform
    const int q_end = min(qt * BQ + BQ, n);
    for (int c0 = qt * BQ; c0 < q_end; c0 += QC) {
      __syncthreads();  // V is staged; the last chunk's readers are done
      for (int e = tid; e < QC * DH; e += DKV_THREADS) {
        const int i = e / DH, d = e % DH;
        const int rr = c0 + i;
        float qv = 0.f, ov = 0.f;
        if (rr < n) {
          qv = to_f32(q[base + (size_t)rr * DH + d]);
          ov = to_f32(dout[base + (size_t)rr * DH + d]);
        }
        qs[i][d] = qv;
        dos[i][d] = ov;
      }
      if (tid < QC) {
        const int rr = c0 + tid;
        lse_s[tid] = rr < n ? lse[(size_t)bh * n + rr] : INFINITY;
        delta_s[tid] = rr < n ? delta[(size_t)bh * n + rr] : 0.f;
      }
      __syncthreads();

      float s[QH], dp[QH];
#pragma unroll
      for (int ii = 0; ii < QH; ++ii) s[ii] = dp[ii] = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        const float kd = kr[d];
        const float vd = vs[r][d];
#pragma unroll
        for (int ii = 0; ii < QH; ++ii) {
          s[ii] = fmaf(kd, qs[hh * QH + ii][d], s[ii]);
          dp[ii] = fmaf(vd, dos[hh * QH + ii][d], dp[ii]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < QH; ++ii) {
        const int i = hh * QH + ii;
        const int rr = c0 + i;
        const bool ok = key_ok && rr < n && mask[(size_t)rr * n + key] != 0;
        const float p = prob(s[ii], scale, kbias, ok, lse_s[i]);
        s[ii] = p;
        dp[ii] = p * (dp[ii] - delta_s[i]);  // ds
      }
#pragma unroll
      for (int ii = 0; ii < QH; ++ii) {
        // the partner thread holds the other half of this key's rows
        const float p_mine = s[ii];
        const float p_other = __shfl_xor_sync(0xffffffffu, p_mine, 1);
        const float ds_mine = dp[ii];
        const float ds_other = __shfl_xor_sync(0xffffffffu, ds_mine, 1);
        const int i_mine = hh * QH + ii, i_other = (1 - hh) * QH + ii;
        const float* do_mine = &dos[i_mine][hh * CH];
        const float* do_other = &dos[i_other][hh * CH];
        const float* q_mine = &qs[i_mine][hh * CH];
        const float* q_other = &qs[i_other][hh * CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          dv_acc[c] = fmaf(p_mine, do_mine[c], dv_acc[c]);
          dv_acc[c] = fmaf(p_other, do_other[c], dv_acc[c]);
          dk_acc[c] = fmaf(ds_mine, q_mine[c], dk_acc[c]);
          dk_acc[c] = fmaf(ds_other, q_other[c], dk_acc[c]);
        }
      }
    }
  }

  if (key_ok) {
    T* dk_out = dk + base + (size_t)key * DH + hh * CH;
    T* dv_out = dv + base + (size_t)key * DH + hh * CH;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      dk_out[c] = from_f32<T>(dk_acc[c] * scale);
      dv_out[c] = from_f32<T>(dv_acc[c]);
    }
  }
}

bool bad_args(int dtype, int bh, int n, int heads, int dh, int block_q,
              int block_k, int nq_tiles, int nk_tiles) {
  return dh != DH || block_q != BQ || block_k != BK || n <= 0 || bh <= 0 ||
         heads <= 0 || bh % heads != 0 || nq_tiles != (n + BQ - 1) / BQ ||
         nk_tiles != (n + BK - 1) / BK || (dtype != 0 && dtype != 1);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype: 0 = float32,
// 1 = bfloat16.  The tile sizes are passed so that a caller built for other
// tiles fails here instead of reading bsum wrongly.  Each returns
// cudaGetLastError() after its launch (0 on success).
extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k,
                            const void* v, const void* mask, const void* bsum,
                            const void* bias, const void* dout,
                            const void* lse, const void* delta, void* dq,
                            int bh, int n, int heads, int dh, int block_q,
                            int block_k, int nq_tiles, int nk_tiles,
                            float scale, void* stream) {
  if (bad_args(dtype, bh, n, heads, dh, block_q, block_k, nq_tiles, nk_tiles))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nq_tiles, bh);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    flash_bwd_dq_kernel<float><<<grid, DQ_THREADS, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const uint8_t*)mask, (const int32_t*)bsum, (const float*)bias,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dq, n, heads, nk_tiles, scale);
  } else {
    flash_bwd_dq_kernel<__nv_bfloat16><<<grid, DQ_THREADS, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const uint8_t*)mask, (const int32_t*)bsum,
        (const float*)bias, (const __nv_bfloat16*)dout, (const float*)lse,
        (const float*)delta, (__nv_bfloat16*)dq, n, heads, nk_tiles, scale);
  }
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k,
                             const void* v, const void* mask,
                             const void* bsum, const void* bias,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int n, int heads, int dh, int block_q,
                             int block_k, int nq_tiles, int nk_tiles,
                             float scale, void* stream) {
  if (bad_args(dtype, bh, n, heads, dh, block_q, block_k, nq_tiles, nk_tiles))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nk_tiles, bh);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    flash_bwd_dkv_kernel<float><<<grid, DKV_THREADS, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const uint8_t*)mask, (const int32_t*)bsum, (const float*)bias,
        (const float*)dout, (const float*)lse, (const float*)delta,
        (float*)dk, (float*)dv, n, heads, nq_tiles, nk_tiles, scale);
  } else {
    flash_bwd_dkv_kernel<__nv_bfloat16><<<grid, DKV_THREADS, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const uint8_t*)mask, (const int32_t*)bsum,
        (const float*)bias, (const __nv_bfloat16*)dout, (const float*)lse,
        (const float*)delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, n, heads,
        nq_tiles, nk_tiles, scale);
  }
  return (int)cudaGetLastError();
}
