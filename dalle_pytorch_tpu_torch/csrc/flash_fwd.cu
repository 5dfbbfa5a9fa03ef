// Block-sparse flash-attention forward for any boolean attention pattern.
//
// Replaces the TPU kernel `_fwd_kernel` of
// dalle_pytorch_tpu/ops/attention_pallas.py (launched by `_call_fwd`): the
// same function, computed as a CUDA kernel for Hopper (sm_90a).
//
//   s   = (q . k^T) * scale + bias[key]          f32, per (row, key)
//   s   = mask[row, key] ? s : NEG_INF           NEG_INF = -1e30 (finite)
//   p   = s <= NEG_INF / 2 ? 0 : exp(s - m)      online softmax, f32
//   o   = sum(p . v) / sum(p)                    0 where every key is masked
//   lse = m + log(sum(p))                        +inf where every key is masked
//
// Layout: q, k, v and o are [bh, n, 64] contiguous (bh = batch * heads) in
// f32 or bf16; o is written in the input type.  mask is [n, n] uint8 shared
// by every (batch, head); bsum is [ceil(n/BQ), ceil(n/BK)] int32, 0 where
// the (q-tile, k-tile) holds no allowed pair; bias is the optional additive
// key-pad bias [b, n] f32 (nullptr for none); lse is [bh, n] f32.  n needs
// no padding: the kernel masks the ragged last tiles itself.
//
// What bounds it on an H100.  At the CUB geometry (n = 1104, 8 heads of 64,
// b = 1) one `full` layer's live tiles are about 1.3 GFLOP, and the bytes
// it must move are about 4.5 MB of q/k/v/o in bf16 plus the 1.2 MB mask:
// a few microseconds at either the tensor-core rate or the 3.35 TB/s of
// HBM, below the cost of a launch.  So the card's peak is not what limits
// this kernel; filling the card is.
//
// What the design does about it.  One thread block per (bh, 64-row q tile):
// at b = 1 that is 8 heads x 18 q tiles = 144 blocks, just over the 132
// SMs, and a block walks its k tiles itself (the TPU kernel's sequential
// grid axis becomes a loop inside the block).  Dead tiles are skipped by
// bsum, so the axial and conv patterns touch O(n sqrt n) tiles.  K and V
// tiles are staged in shared memory as f32; two threads share each query
// row, each holding the row's q in registers, half of the tile's scores
// and half of the output accumulator, and they combine the row max and
// row sum with one warp shuffle.  All arithmetic is f32 on the CUDA
// cores: this first version leaves the tensor cores (wgmma) and TMA
// staging to later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;            // head dim
constexpr int BQ = 64;            // query rows per block
constexpr int BK = 32;            // keys per k tile
constexpr int THREADS = 2 * BQ;   // two threads per query row
constexpr int KH = BK / 2;        // keys per thread per tile
constexpr int CH = DH / 2;        // output columns per thread
constexpr int PAD = DH + 1;       // shared-memory row stride (bank spread)
constexpr float NEG_INF = -1e30f;

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ mask,
                 const int32_t* __restrict__ bsum,
                 const float* __restrict__ bias, T* __restrict__ o,
                 float* __restrict__ lse, int n, int heads, int nk_tiles,
                 float scale) {
  __shared__ float ks[BK][PAD];
  __shared__ float vs[BK][PAD];

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid >> 1;   // query row within the tile
  const int hh = tid & 1;   // which half of the keys / output columns
  const int row = qt * BQ + r;
  const bool row_ok = row < n;
  const size_t base = (size_t)bh * n * DH;

  float qr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d)
    qr[d] = row_ok ? to_f32(q[base + (size_t)row * DH + d]) : 0.f;

  float acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = 0.f;
  float m = NEG_INF;
  float l = 0.f;

  const float* brow = bias ? bias + (size_t)(bh / heads) * n : nullptr;
  const uint8_t* mrow = mask + (size_t)(row_ok ? row : 0) * n;
  const int32_t* brow_sum = bsum + (size_t)qt * nk_tiles;

  for (int kt = 0; kt < nk_tiles; ++kt) {
    if (brow_sum[kt] == 0) continue;  // the same for the whole block
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * DH; e += THREADS) {
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

    float s[KH];
#pragma unroll
    for (int jj = 0; jj < KH; ++jj) s[jj] = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int jj = 0; jj < KH; ++jj)
        s[jj] = fmaf(qd, ks[hh * KH + jj][d], s[jj]);
    }

    float tmax = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < KH; ++jj) {
      const int key = k0 + hh * KH + jj;
      float x = s[jj] * scale;
      bool ok = false;
      if (row_ok && key < n) {
        if (brow) x += brow[key];
        ok = mrow[key] != 0;
      }
      x = ok ? x : NEG_INF;
      s[jj] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);

    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KH; ++jj) {
      // a row whose keys are all masked so far has s == m_new == NEG_INF,
      // where exp(s - m_new) = 1 would leak weight onto masked keys
      const float p = s[jj] <= NEG_INF * 0.5f ? 0.f : expf(s[jj] - m_new);
      s[jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;

#pragma unroll
    for (int c = 0; c < CH; ++c) acc[c] *= alpha;
#pragma unroll
    for (int jj = 0; jj < KH; ++jj) {
      // the partner thread holds the other half of this row's keys
      const float p_mine = s[jj];
      const float p_other = __shfl_xor_sync(0xffffffffu, p_mine, 1);
      const float* v_mine = &vs[hh * KH + jj][hh * CH];
      const float* v_other = &vs[(1 - hh) * KH + jj][hh * CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        acc[c] = fmaf(p_mine, v_mine[c], acc[c]);
        acc[c] = fmaf(p_other, v_other[c], acc[c]);
      }
    }
  }

  if (row_ok) {
    const float l_safe = l == 0.f ? 1.f : l;
    T* orow = o + base + (size_t)row * DH + hh * CH;
#pragma unroll
    for (int c = 0; c < CH; ++c) orow[c] = from_f32<T>(acc[c] / l_safe);
    if (hh == 0)
      lse[(size_t)bh * n + row] = l == 0.f ? INFINITY : m + logf(l_safe);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// The tile sizes are passed so that a caller built for other tiles fails
// here instead of reading bsum wrongly.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, const void* mask, const void* bsum,
                         const void* bias, void* o, void* lse, int bh, int n,
                         int heads, int dh, int block_q, int block_k,
                         int nq_tiles, int nk_tiles, float scale,
                         void* stream) {
  if (dh != DH || block_q != BQ || block_k != BK || n <= 0 || bh <= 0 ||
      heads <= 0 || bh % heads != 0 || nq_tiles != (n + BQ - 1) / BQ ||
      nk_tiles != (n + BK - 1) / BK || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nq_tiles, bh);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    flash_fwd_kernel<float><<<grid, THREADS, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v,
        (const uint8_t*)mask, (const int32_t*)bsum, (const float*)bias,
        (float*)o, (float*)lse, n, heads, nk_tiles, scale);
  } else {
    flash_fwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const uint8_t*)mask,
        (const int32_t*)bsum, (const float*)bias, (__nv_bfloat16*)o,
        (float*)lse, n, heads, nk_tiles, scale);
  }
  return (int)cudaGetLastError();
}
