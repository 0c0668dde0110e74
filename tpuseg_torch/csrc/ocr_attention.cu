// Fused OCR object attention for Hopper (sm_90a).
//
// Replaces the TPU kernel tpuseg/kernels/ocr_attention.py::fused_object_attention
// (pallas_call at :92, Pallas body _attention_kernel). Per image b it computes
//
//     ctx[n, :] = sum_k  round_V(softmax_k(q[n, :] . key[k, :] * scale)) * val[k, :]
//
// with f32 dot products, an f32 softmax, the attention rounded to V's dtype
// before the second product (as the TPU kernel and its plain reference do),
// f32 accumulation and the result stored in Q's dtype.
//
// What bounds it on the H100: device-memory bytes. Q is read once and ctx
// written once: at the 1.0x eval scale N = 131,072 rows of d = 256 bf16,
// 134 MB, a floor of 0.040 ms at 3.35 TB/s. The products are 4 * N * K * d
// FLOPs (2.6 GFLOP at K = 19): 0.038 ms on the CUDA cores' 67 TFLOP/s, as
// long as the memory floor, so only the tensor cores leave the kernel
// memory-bound.
//
// What the design does about it (bf16, the main path):
//   * Persistent blocks of 4 warps, as many as fit on the card. Each warp
//     walks its own 16-row Q tiles independently: no block barrier in the
//     loop. A warp keeps a ring of 2-4 Q tiles in shared memory, filled by
//     cp.async (16 bytes a lane, zero-fill past row N), so the next tiles'
//     bytes are in flight while the current one is computed.
//   * The image's K and V are staged once per block in shared memory,
//     zero-padded to KP = 16 * ceil(K / 16) keys. All rows are 16-byte-chunk
//     XOR-swizzled (chunk ^ (row & 7)), so every ldmatrix is conflict-free.
//   * S = Q Kᵀ on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
//     accumulators): bf16 products are exact in f32, the reference's
//     arithmetic. Keys >= K are masked to -inf; row max and sum use the
//     accumulator fragment and two quad shuffles (xor 1, 2).
//   * P is rounded to bf16 in registers (the reference's attn.to(V.dtype))
//     and, because the m16n8 accumulator layout is the m16n8k16 A layout,
//     feeds ctx = P V directly as the A operand; V's B fragments come from
//     ldmatrix.trans.
//   * The epilogue packs bf16 into the warp's own (now free) Q tile in
//     shared memory, then writes 16-byte vectors, 512 contiguous bytes a row.
// The f32 path (off the main path: what the 1e-4 tests hold) stays a CUDA-
// core kernel: one warp per query row, K and V in shared memory.
//
// C interface (bound with ctypes by tpuseg_torch/kernels/_build.py): launches
// on the given stream, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- bf16 path

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = 16;  // Q rows of one warp tile (one mma M)
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait(int pending) {
  // wait_group takes an immediate: pending is stages - 1, in 1..3
  if (pending >= 3)
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (pending == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D += A (16x16, row) . B (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// byte offset of 16-byte chunk `chunk` of row `row` (rows of `cpr` chunks)
__device__ __forceinline__ uint32_t swz(int row, int chunk, int cpr) {
  return static_cast<uint32_t>((row * cpr + (chunk ^ (row & 7))) * 16);
}

// NT: 16-key tiles, KP = 16 * NT padded keys
template <int NT>
__global__ void __launch_bounds__(kTcThreads)
attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ key,
                    const __nv_bfloat16* __restrict__ val,
                    __nv_bfloat16* __restrict__ out, int batch, int n,
                    int num_keys, int d, float scale, int stages) {
  constexpr int KP = 16 * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int cpr = d / 8;  // 16-byte chunks a row
  const uint32_t sk = smem_u32(smem);
  const uint32_t sv = sk + KP * d * 2;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned char* qring = smem + 2 * KP * d * 2 +
                         static_cast<size_t>(warp) * stages * kTcRows * d * 2;
  const uint32_t sq = smem_u32(qring);
  const uint32_t tile_bytes = kTcRows * d * 2;

  const int tiles = (n + kTcRows - 1) / kTcRows;
  const int gw = blockIdx.x * kTcWarps + warp;
  const int nw = gridDim.x * kTcWarps;
  const int count = gw < tiles ? (tiles - 1 - gw) / nw + 1 : 0;
  const int g = lane / 4;  // accumulator row (and row + 8)
  const int tq = lane % 4;

  for (int b = 0; b < batch; ++b) {
    const size_t img = static_cast<size_t>(b) * n * d;
    // stage K and V of image b, keys >= K zero
    __syncthreads();  // every warp is done with image b - 1
    const size_t kv = static_cast<size_t>(b) * num_keys * d;
    for (int i = threadIdx.x; i < KP * cpr; i += kTcThreads) {
      const int r = i / cpr, c = i % cpr;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
      if (r < num_keys) {
        kk = *reinterpret_cast<const uint4*>(key + kv + r * d + c * 8);
        vv = *reinterpret_cast<const uint4*>(val + kv + r * d + c * 8);
      }
      *reinterpret_cast<uint4*>(smem + swz(r, c, cpr)) = kk;
      *reinterpret_cast<uint4*>(smem + KP * d * 2 + swz(r, c, cpr)) = vv;
    }
    __syncthreads();

    auto load = [&](int j) {  // warp tile j of this warp into its stage
      const int row0 = (gw + j * nw) * kTcRows;
      const uint32_t dst = sq + (j % stages) * tile_bytes;
      for (int ci = lane; ci < kTcRows * cpr; ci += 32) {
        const int r = ci / cpr, c = ci % cpr;
        const bool ok = row0 + r < n;
        const __nv_bfloat16* src = q + img + (ok ? (row0 + r) : 0) *
                                                  static_cast<size_t>(d) +
                                   c * 8;
        cp_async16(dst + swz(r, c, cpr), src, ok);
      }
    };
    for (int j = 0; j < stages - 1; ++j) {
      if (j < count) load(j);
      cp_async_commit();
    }

    for (int j = 0; j < count; ++j) {
      __syncwarp();  // the lanes are done with the stage refilled below
      if (j + stages - 1 < count) load(j + stages - 1);
      cp_async_commit();
      cp_async_wait(stages - 1);  // tile j has landed
      __syncwarp();
      const uint32_t qt = sq + (j % stages) * tile_bytes;
      const int row0 = (gw + j * nw) * kTcRows;

      // S = Q K^T over d, 16 deep a step
      float s[2 * NT][4];
#pragma unroll
      for (int t = 0; t < 2 * NT; ++t)
        s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
      for (int kc = 0; kc < cpr; kc += 2) {
        uint32_t a[4];
        ldsm_x4(a, qt + swz(lane & 15, kc + (lane >> 4), cpr));
#pragma unroll
        for (int p = 0; p < NT; ++p) {
          uint32_t bb[4];
          ldsm_x4(bb, sk + swz(p * 16 + (lane & 7) + ((lane >> 4) << 3),
                               kc + ((lane >> 3) & 1), cpr));
          mma_bf16(s[2 * p], a, bb[0], bb[1]);
          mma_bf16(s[2 * p + 1], a, bb[2], bb[3]);
        }
      }

      // softmax over the K keys of rows g and g + 8, f32, in registers
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int t = 0; t < 2 * NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = t * 8 + 2 * tq + (e & 1);
          s[t][e] = k < num_keys ? s[t][e] * scale : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
        }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
#pragma unroll
      for (int t = 0; t < 2 * NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t][e] = expf(s[t][e] - mx[e >> 1]);
          sum[e >> 1] += s[t][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        sum[h] = 1.f / sum[h];
      }
      // P in bf16, already in the A layout of the second product
      uint32_t pa[NT][4];
#pragma unroll
      for (int p = 0; p < NT; ++p) {
        pa[p][0] = pack_bf16(s[2 * p][0] * sum[0], s[2 * p][1] * sum[0]);
        pa[p][1] = pack_bf16(s[2 * p][2] * sum[1], s[2 * p][3] * sum[1]);
        pa[p][2] = pack_bf16(s[2 * p + 1][0] * sum[0],
                             s[2 * p + 1][1] * sum[0]);
        pa[p][3] = pack_bf16(s[2 * p + 1][2] * sum[1],
                             s[2 * p + 1][3] * sum[1]);
      }

      // ctx = P V, 64 columns at a time, packed into the warp's Q tile
      for (int dc = 0; dc < cpr; dc += 8) {
        float o[8][4];
#pragma unroll
        for (int t = 0; t < 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
        for (int p = 0; p < NT; ++p)
#pragma unroll
          for (int c2 = 0; c2 < 4; ++c2) {
            uint32_t bb[4];
            ldsm_x4_t(bb, sv + swz(p * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                   dc + 2 * c2 + (lane >> 4), cpr));
            mma_bf16(o[2 * c2], pa[p], bb[0], bb[1]);
            mma_bf16(o[2 * c2 + 1], pa[p], bb[2], bb[3]);
          }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          unsigned char* base = qring + (j % stages) * tile_bytes + 4 * tq;
          *reinterpret_cast<uint32_t*>(base + swz(g, dc + t, cpr)) =
              pack_bf16(o[t][0], o[t][1]);
          *reinterpret_cast<uint32_t*>(base + swz(g + 8, dc + t, cpr)) =
              pack_bf16(o[t][2], o[t][3]);
        }
      }
      __syncwarp();
      const unsigned char* tile = qring + (j % stages) * tile_bytes;
      for (int ci = lane; ci < kTcRows * cpr; ci += 32) {
        const int r = ci / cpr, c = ci % cpr;
        if (row0 + r < n)
          *reinterpret_cast<uint4*>(out + img + (row0 + r) *
                                                    static_cast<size_t>(d) +
                                    c * 8) =
              *reinterpret_cast<const uint4*>(tile + swz(r, c, cpr));
      }
    }
    // nothing of this image is left in flight (the trailing empty groups)
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
}

size_t tc_smem(int kp, int d, int stages) {
  return 2 * static_cast<size_t>(kp) * d * 2 +
         static_cast<size_t>(kTcWarps) * stages * kTcRows * d * 2;
}

struct TcConfig {
  int d = 0, stages = 0, per_sm = 0, sms = 0;
};

// the deepest ring at which two blocks share an SM, else the deepest that
// fits one block; worked out once per device, key tiles and width
template <int NT>
const TcConfig& tc_config(int d) {
  static TcConfig cfg_of[64];
  int dev = 0;
  cudaGetDevice(&dev);
  TcConfig& cfg = cfg_of[dev & 63];
  if (cfg.d == d) return cfg;
  auto kernel = attention_tc_kernel<NT>;
  cfg = TcConfig();
  cudaDeviceGetAttribute(&cfg.sms, cudaDevAttrMultiProcessorCount, dev);
  for (int s = 4; s >= 2 && cfg.per_sm < 2; --s) {
    const size_t bytes = tc_smem(16 * NT, d, s);
    if (bytes > static_cast<size_t>(kSmemLimit)) continue;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                  kTcThreads, bytes);
    if (blocks >= 2 || (blocks >= 1 && cfg.stages == 0)) {
      cfg.stages = s;
      cfg.per_sm = blocks;
    }
  }
  if (cfg.stages > 0) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(tc_smem(16 * NT, d, cfg.stages)));
    cfg.d = d;
  }
  return cfg;
}

template <int NT>
int launch_tc(const void* q, const void* key, const void* val, void* out,
              int batch, int n, int num_keys, int d, float scale,
              cudaStream_t stream) {
  const TcConfig& cfg = tc_config<NT>(d);
  if (cfg.stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + kTcRows - 1) / kTcRows;
  const int grid = min(cfg.sms * cfg.per_sm, (tiles + kTcWarps - 1) / kTcWarps);
  attention_tc_kernel<NT><<<grid, kTcThreads, tc_smem(16 * NT, d, cfg.stages),
                            stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(key),
      static_cast<const __nv_bfloat16*>(val),
      static_cast<__nv_bfloat16*>(out), batch, n, num_keys, d, scale,
      cfg.stages);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* key, const void* val, void* out,
                int batch, int n, int num_keys, int d, float scale,
                cudaStream_t s) {
  if (d % 64 || num_keys < 1 || num_keys > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((num_keys + 15) / 16) {
    case 1: return launch_tc<1>(q, key, val, out, batch, n, num_keys, d, scale, s);
    case 2: return launch_tc<2>(q, key, val, out, batch, n, num_keys, d, scale, s);
    case 3: return launch_tc<3>(q, key, val, out, batch, n, num_keys, d, scale, s);
    case 4: return launch_tc<4>(q, key, val, out, batch, n, num_keys, d, scale, s);
    case 5: return launch_tc<5>(q, key, val, out, batch, n, num_keys, d, scale, s);
    case 6: return launch_tc<6>(q, key, val, out, batch, n, num_keys, d, scale, s);
    case 7: return launch_tc<7>(q, key, val, out, batch, n, num_keys, d, scale, s);
    default: return launch_tc<8>(q, key, val, out, batch, n, num_keys, d, scale, s);
  }
}

// ----------------------------------------------------------------- f32 path

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

__device__ __forceinline__ void store8(float* p, const float (&r)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(r[4], r[5], r[6], r[7]);
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

// one warp per query row: f32 dot products reduced with shuffles, the
// softmax through a per-warp shared scratch of K floats
__global__ void __launch_bounds__(kThreads)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ key,
                     const float* __restrict__ val, float* __restrict__ out,
                     int n, int num_keys, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + static_cast<size_t>(num_keys) * d;
  float* scratch = sv + static_cast<size_t>(num_keys) * d;

  const int b = blockIdx.y;
  const size_t kv_off = static_cast<size_t>(b) * num_keys * d;
  const int vecs = num_keys * d / 4;
  const float4* gk = reinterpret_cast<const float4*>(key + kv_off);
  const float4* gv = reinterpret_cast<const float4*>(val + kv_off);
  for (int i = threadIdx.x; i < vecs; i += kThreads) {
    reinterpret_cast<float4*>(sk)[i] = gk[i];
    reinterpret_cast<float4*>(sv)[i] = gv[i];
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
    for (int k = 0; k < num_keys; ++k) {
      const float* kr = sk + static_cast<size_t>(k) * d;
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
    for (int k = lane; k < num_keys; k += 32) ps[k] = ps[k] / sum;
    __syncwarp();
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

int launch_f32(const void* q, const void* key, const void* val, void* out,
               int batch, int n, int num_keys, int d, float scale,
               cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(num_keys) * d * sizeof(float) +
                      static_cast<size_t>(kWarps) * num_keys * sizeof(float);
  cudaFuncSetAttribute(attention_f32_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, batch);
  attention_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(key),
      static_cast<const float*>(val), static_cast<float*>(out), n, num_keys,
      d, scale);
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
    return launch_bf16(q, key, val, out, batch, n, num_keys, d, scale, s);
  return launch_f32(q, key, val, out, batch, n, num_keys, d, scale, s);
}
