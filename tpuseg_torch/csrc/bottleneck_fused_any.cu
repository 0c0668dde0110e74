// Fused eval-mode HRNet stage-1 Bottleneck at any width, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpuseg/kernels/bottleneck_fused.py::fused_bottleneck
// (pallas_call at :118, Pallas body _kernel) at the widths that
// bottleneck_fused.cu, laid out for (C, M) = (256, 64) alone, does not take.
// The TPU kernel takes any C and M; this one takes every (C, M) with C and M
// multiples of 8, C <= 1024 and M <= 256 (tpuseg_torch/kernels/
// bottleneck_fused.py::supports). With each BN folded into its conv it
// computes, for an NHWC bf16 batch x of C channels,
//
//     t1  = bf16(relu(conv1x1(x, w1) + b1))            C -> M
//     t2  = bf16(relu(conv3x3(t1, w2) + b2))           M -> M, zero padding 1
//     out = bf16(relu(conv1x1(t2, w3) + b3 + x))       M -> C
//
// with bf16 operands and f32 accumulation: the block's math, as
// bottleneck_reference computes it. t1 is ZERO at 3x3 taps outside the image
// (the TPU kernel reads relu(b1) there: ROADMAP Queue 3).
//
// What bounds it on the H100: device-memory bytes, x read and out written
// once (at (128, 32) on the 2.0x map, 1 x 512 x 1024 x 128, 268 MB: 0.080 ms
// at 3.35 TB/s, against 0.019 ms for its 19 GFLOP at 989 TFLOP/s).
//
// The design is the simple one: correct at every width first, fast later.
//   * One block of 8 warps per th x 8 output tile of one image (th = 8, or
//     4 where the 8-row tile's shared memory would pass 227 KB, i.e. at the
//     widest C and M). No persistence, no warp specialisation.
//   * The tile's (th + 2) x 10 halo window of x, all C channels, is staged
//     once into shared memory with cp.async (16 bytes a thread), zero outside
//     the image and in the channels past C up to a multiple of 16. Rows are
//     padded by 16 bytes, so a row is an odd number of 16-byte chunks and
//     every ldmatrix over 8 rows is conflict-free.
//   * The three products run on mma.sync m16n8k16 (bf16, f32 accumulate),
//     64 output columns a pass: warp w takes 16 columns (w % 4) and every
//     other 16-row tile (w / 4). The weights are read from device memory
//     (through L2) in 64 x 64 chunks, staged by cp.async into two shared
//     buffers while the previous chunk's products run, and read as B
//     fragments with ldmatrix.trans. Rows and columns past K or N are
//     zero-filled, which pads K to 16 where M or C is 8 modulo 16.
//   * conv1 over the window's rows -> + b1, ReLU, zero outside the image,
//     bf16 into t1 in shared memory. conv2 as nine shifted products: the A
//     rows of tap (dy, dx) are gathered by ldmatrix's per-lane row addresses
//     from t1 -> + b2, ReLU, bf16 into t2. conv3 -> + b3 + the residual, read
//     from the staged window's interior, ReLU, bf16 written back in place
//     over that residual; then the tile goes out in 16-byte stores, clipped
//     at the ragged right and bottom edges.
// What it leaves on the table (a later perf PR): the window's halo is
// staged and multiplied again by each neighbour (1.56x the pixels at th =
// 8), the weights are re-read from L2 by every tile, each chunk costs two
// block barriers, and nothing overlaps one tile's loads with another's
// products.
//
// C interface (bound with ctypes by tpuseg_torch/kernels/_build.py): launches
// on the given stream, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // 8 warps
constexpr int kTW = 8;                   // output tile width
constexpr int kWW = kTW + 2;             // window width
constexpr int kNB = 64;                  // output columns a pass
constexpr int kKC = 64;                  // weight rows a staged chunk
constexpr int kBRow = (kNB + 8) * 2;     // 144 bytes: 9 chunks of 16
constexpr int kBStage = kKC * kBRow;
constexpr int kSmemLimit = 232448;       // shared memory a block may use
constexpr int kMaxC = 1024, kMaxM = 256;

__host__ __device__ __forceinline__ int up16(int v) { return (v + 15) & ~15; }

// the shared-memory map of one (C, M, th); byte offsets, all 16-aligned
struct Geo {
  int cp, mp;     // C and M padded to 16 (the products' K)
  int wp, p;      // window pixels (th + 2) * 10, output pixels th * 8
  int xs, ts;     // row strides of the window and of t1 / t2, bytes
  int t1, t2, bs, bytes;
};

__host__ __device__ __forceinline__ Geo geometry(int c, int m, int th) {
  Geo g;
  g.cp = up16(c);
  g.mp = up16(m);
  g.wp = (th + 2) * kWW;
  g.p = th * kTW;
  g.xs = (g.cp + 8) * 2;
  g.ts = (g.mp + 8) * 2;
  g.t1 = up16(g.wp) * g.xs;   // the window: its rows padded to 16
  g.t2 = g.t1 + g.wp * g.ts;
  g.bs = g.t2 + g.p * g.ts;
  g.bytes = g.bs + 2 * kBStage;
  return g;
}

__host__ __device__ __forceinline__ int tile_rows(int c, int m) {
  return geometry(c, m, 8).bytes <= kSmemLimit ? 8 : 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; valid = false zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>  // until at most N committed groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// A warp's accumulators in a 64-column pass: up to 4 row tiles of 16 (tiles
// wm, wm + 2, ...) by 2 column tiles of 8 (columns wn * 16 ..).
typedef float Acc[4][2][4];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// acc += A . B[:, n0 : n0 + 64] over `segs` segments of K = k_real rows
// (padded to 16): segment s reads its A rows at a_row(row, s) in shared
// memory and its B rows from b + s * seg_stride, row-major with n_real
// columns. B goes through the two staging buffers at `stage`.
template <class ARow>
__device__ __forceinline__ void gemm(Acc& acc, ARow a_row, int mtiles,
                                     const __nv_bfloat16* __restrict__ b,
                                     int k_real, int n_real, int segs,
                                     size_t seg_stride, int n0,
                                     uint32_t stage) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int wm = (tid >> 5) >> 2, wn = (tid >> 5) & 3;
  const int kpad = up16(k_real);
  const int kchunks = (kpad + kKC - 1) / kKC;
  const int total = segs * kchunks;
  auto load = [&](int q) {
    const int s = q / kchunks, kc = q % kchunks;
    const uint32_t dst = stage + (q & 1) * kBStage;
    const __nv_bfloat16* src = b + s * seg_stride;
    for (int i = tid; i < kKC * (kNB / 8); i += kThreads) {
      const int r = i >> 3, cc = i & 7;
      const int k = kc * kKC + r, n = n0 + cc * 8;
      const bool ok = k < k_real && n < n_real;
      cp_async16(dst + r * kBRow + cc * 16,
                 ok ? src + static_cast<size_t>(k) * n_real + n : b, ok);
    }
  };
  load(0);
  cp_async_commit();
  for (int q = 0; q < total; ++q) {
    if (q + 1 < total) {
      load(q + 1);
      cp_async_commit();
      cp_async_wait<1>();  // chunk q (and everything before it) has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = q / kchunks, kc = q % kchunks;
    const uint32_t bq = stage + (q & 1) * kBStage;
    const int steps = min(kKC, kpad - kc * kKC) / 16;
    for (int ks = 0; ks < steps; ++ks) {
      uint32_t bb[4];  // B fragments of column tiles 0 and 1
      const int krow = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldsm_x4_t(bb, bq + krow * kBRow + (wn * 16 + (lane >> 4) * 8) * 2);
      const int kcol = kc * kKC + ks * 16 + (lane >> 4) * 8;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mt = wm + 2 * i;
        if (mt < mtiles) {
          uint32_t a[4];
          ldsm_x4(a, a_row(mt * 16 + (lane & 15), s) + kcol * 2);
          mma_bf16(acc[i][0], a, bb[0], bb[1]);
          mma_bf16(acc[i][1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer q & 1
  }
}

// f(row, col, v0, v1) for each accumulator pair of the warp: row of the
// product, columns col and col + 1 of the pass starting at n0
template <class F>
__device__ __forceinline__ void epilogue(const Acc& acc, int mtiles, int n0,
                                         F f) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int wm = (tid >> 5) >> 2, wn = (tid >> 5) & 3;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mt = wm + 2 * i;
    if (mt >= mtiles) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + wn * 16 + j * 8 + 2 * tq;
      f(mt * 16 + g, col, acc[i][j][0], acc[i][j][1]);
      f(mt * 16 + g + 8, col, acc[i][j][2], acc[i][j][3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bottleneck_any_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w1,
                      const float* __restrict__ b1,
                      const __nv_bfloat16* __restrict__ w2,
                      const float* __restrict__ b2,
                      const __nv_bfloat16* __restrict__ w3,
                      const float* __restrict__ b3,
                      __nv_bfloat16* __restrict__ out, int h, int w, int c,
                      int m, int th) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geo geo = geometry(c, m, th);
  const int tid = threadIdx.x;
  const int tiles_w = (w + kTW - 1) / kTW, tiles_h = (h + th - 1) / th;
  const int tx = blockIdx.x % tiles_w;
  const int ty = (blockIdx.x / tiles_w) % tiles_h;
  const int b = blockIdx.x / (tiles_w * tiles_h);
  const int y0 = ty * th, x0 = tx * kTW;
  const size_t img = static_cast<size_t>(b) * h * w * c;
  const uint32_t xw = smem_u32(smem), t1 = xw + geo.t1, t2 = xw + geo.t2;
  const uint32_t stage = xw + geo.bs;
  const int xs = geo.xs, ts = geo.ts;

  // the halo window, every channel; zero outside the image and past C
  const int cpr = geo.cp / 8;
  for (int i = tid; i < up16(geo.wp) * cpr; i += kThreads) {
    const int r = i / cpr, cc = i % cpr;
    const int iy = y0 - 1 + r / kWW, ix = x0 - 1 + r % kWW;
    const bool ok = r < geo.wp && cc * 8 < c && iy >= 0 && iy < h &&
                    ix >= 0 && ix < w;
    cp_async16(xw + r * xs + cc * 16,
               ok ? x + img + (static_cast<size_t>(iy) * w + ix) * c + cc * 8
                  : x,
               ok);
  }
  cp_async_commit();  // waited for with the first weight chunk

  Acc acc;
  // conv1 over the window's rows -> t1, zero outside the image
  for (int n0 = 0; n0 < geo.mp; n0 += kNB) {
    zero(acc);
    gemm(acc, [=](int r, int) { return xw + r * xs; }, up16(geo.wp) / 16, w1,
         c, m, 1, 0, n0, stage);
    epilogue(acc, up16(geo.wp) / 16, n0, [&](int r, int col, float v0,
                                             float v1) {
      if (r >= geo.wp || col >= geo.mp) return;
      const int iy = y0 - 1 + r / kWW, ix = x0 - 1 + r % kWW;
      const bool in = iy >= 0 && iy < h && ix >= 0 && ix < w;
      const float c0 = col < m ? __ldg(b1 + col) : 0.f;
      const float c1 = col < m ? __ldg(b1 + col + 1) : 0.f;
      *reinterpret_cast<uint32_t*>(smem + geo.t1 + r * ts + col * 2) =
          in ? pack_bf16(fmaxf(v0 + c0, 0.f), fmaxf(v1 + c1, 0.f)) : 0u;
    });
  }
  __syncthreads();

  // conv2: nine shifted products over t1 -> t2
  for (int n0 = 0; n0 < geo.mp; n0 += kNB) {
    zero(acc);
    gemm(acc,
         [=](int p, int tap) {
           return t1 + ((p / kTW + tap / 3) * kWW + p % kTW + tap % 3) * ts;
         },
         geo.p / 16, w2, m, m, 9, static_cast<size_t>(m) * m, n0, stage);
    epilogue(acc, geo.p / 16, n0, [&](int p, int col, float v0, float v1) {
      if (col >= geo.mp) return;
      const float c0 = col < m ? __ldg(b2 + col) : 0.f;
      const float c1 = col < m ? __ldg(b2 + col + 1) : 0.f;
      *reinterpret_cast<uint32_t*>(smem + geo.t2 + p * ts + col * 2) =
          pack_bf16(fmaxf(v0 + c0, 0.f), fmaxf(v1 + c1, 0.f));
    });
  }
  __syncthreads();

  // conv3 + b3 + the residual from the window's interior, ReLU, bf16 in
  // place of the residual
  for (int n0 = 0; n0 < c; n0 += kNB) {
    zero(acc);
    gemm(acc, [=](int p, int) { return t2 + p * ts; }, geo.p / 16, w3, m, c,
         1, 0, n0, stage);
    epilogue(acc, geo.p / 16, n0, [&](int p, int col, float v0, float v1) {
      if (col >= c) return;
      uint32_t* at = reinterpret_cast<uint32_t*>(
          smem + ((p / kTW + 1) * kWW + p % kTW + 1) * xs + col * 2);
      const float2 res =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
      *at = pack_bf16(fmaxf(v0 + __ldg(b3 + col) + res.x, 0.f),
                      fmaxf(v1 + __ldg(b3 + col + 1) + res.y, 0.f));
    });
  }
  __syncthreads();

  // the tile out, clipped at the ragged edges
  const int cpo = c / 8;
  for (int i = tid; i < geo.p * cpo; i += kThreads) {
    const int p = i / cpo, cc = i % cpo;
    const int iy = y0 + p / kTW, ix = x0 + p % kTW;
    if (iy < h && ix < w)
      *reinterpret_cast<uint4*>(out + img +
                                (static_cast<size_t>(iy) * w + ix) * c +
                                cc * 8) =
          *reinterpret_cast<const uint4*>(
              smem + ((p / kTW + 1) * kWW + p % kTW + 1) * xs + cc * 16);
  }
}

}  // namespace

// x (batch, h, w, c) bf16 NHWC; w1 (c, m), w2 (9, m, m) tap-major (tap, in,
// out), w3 (m, c) bf16; b1 (m), b2 (m), b3 (c) f32; out like x. Every
// pointer 16-byte aligned, c and m multiples of 8, c <= 1024, m <= 256.
extern "C" int tpuseg_bottleneck_any(const void* x, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, const void* w3,
                                     const void* b3, void* out, int batch,
                                     int h, int w, int c, int m,
                                     void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (c % 8 || m % 8 || c < 8 || m < 8 || c > kMaxC || m > kMaxM ||
      batch < 1 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // per device, once: the opt-in to 227 KB of dynamic shared memory
  static bool opted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (!opted[dev & 63]) {
    cudaFuncSetAttribute(bottleneck_any_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemLimit);
    opted[dev & 63] = true;
  }
  const int th = tile_rows(c, m);
  const long long tiles = static_cast<long long>(batch) *
                          ((h + th - 1) / th) * ((w + kTW - 1) / kTW);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bottleneck_any_kernel<<<static_cast<unsigned>(tiles), kThreads,
                          geometry(c, m, th).bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<const __nv_bfloat16*>(w3), static_cast<const float*>(b3),
      static_cast<__nv_bfloat16*>(out), h, w, c, m, th);
  return static_cast<int>(cudaGetLastError());
}
