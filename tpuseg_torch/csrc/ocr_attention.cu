// Fused OCR object attention for Hopper (sm_90a).
//
// Replaces the TPU kernel tpuseg/kernels/ocr_attention.py::fused_object_attention
// (Pallas body _attention_kernel). Per image b it computes
//
//     ctx[n, :] = sum_k  round_V(softmax_k(q[n, :] . key[k, :] * scale)) * val[k, :]
//
// with f32 dot products, an f32 softmax, the attention rounded to V's dtype
// before the second product (as the TPU kernel and its plain reference do),
// f32 accumulation and the result stored in Q's dtype.
//
// What bounds it on the H100: device-memory bytes. Q is read once and ctx
// written once (at the 2.0x eval scale, N = 524,288 rows of d = 256 bf16:
// 268 MB each way, a floor of ~0.16 ms at 3.35 TB/s); the 2 * N * K * d
// FLOPs are negligible at K = 19 classes.
//
// What the design does about it: one block of 8 warps per tile of 128 rows;
// the image's K and V (at most 128 x d each, 9.7 KB at K = 19, d = 256 bf16)
// are staged once per block in shared memory, so every Q byte is read from
// device memory exactly once and every ctx byte written once. One warp owns
// one query row at a time: each lane holds 8 elements of q per 256-wide
// chunk (one 16-byte load), the K dot products are reduced with warp
// shuffles, and the (row, k) similarities and probabilities live in a
// per-warp shared scratch of K floats; neither sim nor attn ever reaches
// device memory. Keys >= K are never read, which is the TPU kernel's -1e30
// mask on its 128-lane padding made implicit. The TPU layout choices
// (K padded to 128 lanes, 2048-row tiles) are not carried over.
//
// C interface (bound with ctypes by tpuseg_torch/kernels/_build.py): launches
// on the given stream, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 128;
constexpr int kMaxChunks = 4;  // d <= 4 * 256

__device__ __forceinline__ void load8(const float* p, float (&r)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&r)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    r[2 * i] = f.x;
    r[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&r)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(r[4], r[5], r[6], r[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&r)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(r[2 * i], r[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// the attention is rounded to V's dtype before the second product
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ key,
                 const T* __restrict__ val, T* __restrict__ out, int n,
                 int num_keys, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + static_cast<size_t>(num_keys) * d;
  float* scratch = reinterpret_cast<float*>(sv + static_cast<size_t>(num_keys) * d);

  const int b = blockIdx.y;
  const size_t kv_off = static_cast<size_t>(b) * num_keys * d;

  // stage this image's K and V once, 16 bytes per thread per step
  const int vecs = static_cast<int>(static_cast<size_t>(num_keys) * d * sizeof(T) / 16);
  const uint4* gk = reinterpret_cast<const uint4*>(key + kv_off);
  const uint4* gv = reinterpret_cast<const uint4*>(val + kv_off);
  uint4* s4k = reinterpret_cast<uint4*>(sk);
  uint4* s4v = reinterpret_cast<uint4*>(sv);
  for (int i = threadIdx.x; i < vecs; i += kThreads) {
    s4k[i] = gk[i];
    s4v[i] = gv[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* ps = scratch + warp * num_keys;
  const int row0 = static_cast<int>(blockIdx.x) * kRowsPerBlock;
  const int row_end = min(row0 + kRowsPerBlock, n);

  for (int row = row0 + warp; row < row_end; row += kWarps) {
    const size_t row_off = (static_cast<size_t>(b) * n + row) * d;
    float qv[kMaxChunks][8];
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int e = c * 256 + lane * 8;
      if (e < d) {
        load8(q + row_off + e, qv[c]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) qv[c][j] = 0.f;
      }
    }

    // similarities, f32
    for (int k = 0; k < num_keys; ++k) {
      const T* kr = sk + static_cast<size_t>(k) * d;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int e = c * 256 + lane * 8;
        if (e < d) {
          float kv[8];
          load8(kr + e, kv);
#pragma unroll
          for (int j = 0; j < 8; ++j) s = fmaf(qv[c][j], kv[j], s);
        }
      }
      s = warp_sum(s);
      if (lane == 0) ps[k] = s * scale;
    }
    __syncwarp();

    // softmax over the K keys, f32: exp(s - max) / sum
    float mx = -INFINITY;
    for (int k = lane; k < num_keys; k += 32) mx = fmaxf(mx, ps[k]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int k = lane; k < num_keys; k += 32) {
      const float e = expf(ps[k] - mx);
      ps[k] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int k = lane; k < num_keys; k += 32) ps[k] = round_to(ps[k] / sum, sv);
    __syncwarp();

    // context: sum_k p_k * v_k, f32 accumulation
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int e = c * 256 + lane * 8;
      if (e < d) {
        float acc[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = 0.f;
        for (int k = 0; k < num_keys; ++k) {
          const float p = ps[k];
          float vv[8];
          load8(sv + static_cast<size_t>(k) * d + e, vv);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] = fmaf(p, vv[j], acc[j]);
        }
        store8(out + row_off + e, acc);
      }
    }
    __syncwarp();  // ps is rewritten by the next row
  }
}

template <typename T>
int launch(const void* q, const void* key, const void* val, void* out,
           int batch, int n, int num_keys, int d, float scale,
           cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(num_keys) * d * sizeof(T) +
                      static_cast<size_t>(kWarps) * num_keys * sizeof(float);
  cudaFuncSetAttribute(attention_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, batch);
  attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(key),
      static_cast<const T*>(val), static_cast<T*>(out), n, num_keys, d, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpuseg_ocr_attention(const void* q, const void* key,
                                    const void* val, void* out, int batch,
                                    int n, int num_keys, int d, float scale,
                                    int is_bf16, void* stream) {
  cudaGetLastError();  // start from a clean error state
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, key, val, out, batch, n, num_keys, d, scale, s);
  return launch<float>(q, key, val, out, batch, n, num_keys, d, scale, s);
}
