// Forward 3x3 convolution at any dilation, stride 1, groups 1, for Hopper
// (sm_90a): ASPP's atrous convs (models/heads.py).
//
// Replaces no tpuseg Pallas kernel: XLA compiles tpuseg's dilated convs. It
// was added because cuDNN's forward for these shapes runs at ~3 % of the
// card's peak: on NCHW memory (where models/heads.py sent them, since
// cuDNN's channels_last kernels for rates 12-36 took ~1 s) it picks the
// legacy implicit_convolve_sgemm, 20.2 ms a crop of the DeepLabV3+ train
// step's 51.8 (PERF.md §5). It computes, for a bf16 NHWC input x (B, H, W,
// Cin) and bf16 weights packed tap-major as wp (9, Cout, Cin),
//
//     out[b, oy, ox, co] = bf16( sum_{ky, kx, ci}
//         x[b, oy - pad_h + d ky, ox - pad_w + d kx, ci] * wp[3 ky + kx, co, ci] )
//
// with f32 accumulation, zero outside the image, and out (B, Ho, Wo, Cout)
// NHWC, Ho = H + 2 pad_h - 2 d, Wo = W + 2 pad_w - 2 d. pad_h and pad_w are
// separate so that a dp x sp band whose halo rows were fetched (pad_h 0,
// parallel/spatial.py conv_rows) takes the kernel too.
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16): operations. The
// DeepLabV3+ train cell's convs are 4096 -> 256 at 8 x 100 x 100: 1.51 TFLOP
// each over every tap, 1.28 at rate 12 to 0.87 at rate 36 over the taps that
// land in the image, against 0.72 GB of bytes (x, weights, out once each).
//
// The design: an implicit GEMM, M = output pixels, N = Cout, K = 9 taps x
// Cin, every K step a 64-channel chunk of one tap.
//   * Persistent blocks, one an SM, walk output tiles of 8 rows x 16 columns
//     (128 pixels) in row-major order. A block is two consumer warpgroups
//     (64 pixels each, the whole N: wgmma m64nNk16, N = Cout <= 256, f32
//     accumulators in 128 registers a thread at N = 256) and a producer
//     warpgroup whose one thread keeps a ring of stages full behind
//     full/empty mbarriers; setmaxnreg moves the producer's registers to
//     the consumers.
//   * A stage is one K step: the tile's input box at the tap's shift (TMA,
//     a 4-D map over NHWC, box 64 channels x 16 x 8, 128B swizzle, 16 KB) and
//     the tap's 64-channel weight chunk (TMA, a 2-D map over (9 Cout, Cin),
//     box 64 x Cout, 128B swizzle). TMA's out-of-bounds zero fill is the
//     conv's padding, the ragged edge and the channels past Cin. Both tiles
//     are wgmma's K-major 128B-swizzled operands as TMA lays them down.
//   * K runs chunk-major (every tap of a 64-channel chunk, then the next
//     chunk), so that the blocks of one wave read the same thin slice of x
//     and of the weights at about the same time and find it in L2: each x
//     byte is read by 9 (tile, tap) pairs.
//   * A tap whose box lies wholly outside the image for the tile's stored
//     pixels is skipped by producer and consumers alike (a mask computed from
//     the tile's coordinates alone): at rate 36 on 100 x 100, 42 % of the
//     tap-pixel pairs are padding.
//   * A consumer keeps one stage's products in flight while it issues the
//     next stage's, and returns a stage to the producer once its products
//     have finished. The epilogue rounds to bf16 and stores straight from
//     registers (16 B a quad of lanes), masked at the ragged edge; its
//     shared memory goes to the ring instead (4 stages at Cout = 256).
// What it leaves on the table (PERF.md §6; 46-52 % of the in-image-tap
// bound at the train cell's rates): the ragged tiles (8 x 16 tiles cover
// 100 x 100 as 104 x 112) and the padding inside a tap box that reaches the
// image are multiplied all the same; each block reads the weight chunk of
// every stage from L2 for its 128 pixels (no cluster multicast), so at
// Cout = 256 a stage brings 48 KB for 4.2 MFLOP.
//
// C interface (bound with ctypes by tpuseg_torch/kernels/_build.py): launches
// on the given stream, allocates nothing, returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemLimit = 232448;  // shared memory a block may use
constexpr int kTW = 16, kTH = 8;    // output tile: 8 rows x 16 columns
constexpr int kABytes = kTW * kTH * 128;  // a tile's 64-channel box, 16 KB
constexpr int kMaxStages = 8;
constexpr int kConsumers = 2;  // consumer warpgroups, 64 pixels each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

__host__ __device__ __forceinline__ constexpr int stage_bytes(int n) {
  return kABytes + 128 * n;  // the input box and a 64 x N weight chunk
}

// stages of the ring at N = Cout, from a 1024-aligned base
__host__ __device__ __forceinline__ constexpr int stages_for(int n) {
  return (kSmemLimit - 1024 - 2 * kMaxStages * 8) / stage_bytes(n) <
                 kMaxStages
             ? (kSmemLimit - 1024 - 2 * kMaxStages * 8) / stage_bytes(n)
             : kMaxStages;
}

struct Shape {
  int batch, h, w, cin, ho, wo, pad_h, pad_w, dil;
  int tiles_x, tiles_y, tiles, chunks;  // chunks: 64-channel K steps a tap
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// a wait that never ends (a protocol fault) traps after ~2 s instead of
// hanging the card; a healthy wait lasts microseconds
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t since = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if ((spins & 1023) == 1023) {
      const uint64_t now = globaltimer_ns();
      if (since == 0) since = now;
      else if (now - since > 2000000000ull) __trap();
    }
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          int c, int x, int y, int b,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(b),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load2(uint32_t dst, const CUtensorMap* map,
                                          int c, int r, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major, 128B-swizzled operand (TMA's layout of a
// box whose rows are 64 bf16): 8-row atoms 1024 B apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // until at most N committed groups are still running
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// wgmma m64nNk16 bf16 -> f32, A and B K-major in shared memory:
// D (64 x N, N / 2 registers a thread) += A . B (the accumulators start at
// zero). The operand lists are spelled 8 registers at a time.
#define WG_S(a, b, c, d, e, f, g, h) \
  "%" #a ", %" #b ", %" #c ", %" #d ", %" #e ", %" #f ", %" #g ", %" #h
#define WG_64                                                         \
  WG_S(0, 1, 2, 3, 4, 5, 6, 7) ", " WG_S(8, 9, 10, 11, 12, 13, 14, 15) \
      ", " WG_S(16, 17, 18, 19, 20, 21, 22, 23) ", "                   \
      WG_S(24, 25, 26, 27, 28, 29, 30, 31)
#define WG_128                                                            \
  WG_64 ", " WG_S(32, 33, 34, 35, 36, 37, 38, 39) ", "                    \
      WG_S(40, 41, 42, 43, 44, 45, 46, 47) ", "                           \
      WG_S(48, 49, 50, 51, 52, 53, 54, 55) ", " WG_S(56, 57, 58, 59, 60, 61, \
                                                    62, 63)
#define WG_192                                                           \
  WG_128 ", " WG_S(64, 65, 66, 67, 68, 69, 70, 71) ", "                  \
      WG_S(72, 73, 74, 75, 76, 77, 78, 79) ", "                          \
      WG_S(80, 81, 82, 83, 84, 85, 86, 87) ", " WG_S(88, 89, 90, 91, 92, 93, \
                                                    94, 95)
#define WG_256                                                            \
  WG_192 ", " WG_S(96, 97, 98, 99, 100, 101, 102, 103) ", "               \
      WG_S(104, 105, 106, 107, 108, 109, 110, 111) ", "                   \
      WG_S(112, 113, 114, 115, 116, 117, 118, 119) ", "                   \
      WG_S(120, 121, 122, 123, 124, 125, 126, 127)
#define WG_R(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_R32(i) WG_R(i), WG_R(i + 8), WG_R(i + 16), WG_R(i + 24)

template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b);

#define WGMMA_SS(N, REGS, IA, IB, IP, ...)                                   \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_ss<N>(float (&d)[N / 2], uint64_t a, \
                                              uint64_t b) {                 \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IP ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N                      \
                 "k16.f32.bf16.bf16 {" REGS "}, %" #IA ", %" #IB             \
                 ", p, 1, 1, 0, 0;\n}\n"                                     \
                 : __VA_ARGS__                                               \
                 : "l"(a), "l"(b), "r"(1));                                  \
  }

WGMMA_SS(64, WG_64, 32, 33, 34, WG_R32(0))
WGMMA_SS(128, WG_128, 64, 65, 66, WG_R32(0), WG_R32(32))
WGMMA_SS(192, WG_192, 96, 97, 98, WG_R32(0), WG_R32(32), WG_R32(64))
WGMMA_SS(256, WG_256, 128, 129, 130, WG_R32(0), WG_R32(32), WG_R32(64),
         WG_R32(96))

// The tile at output (oy0, ox0): its taps whose input box reaches the image
// for the tile's stored pixels, as a list of 4-bit tap numbers (low first),
// and their count. Computed from the shape and the tile alone, so the
// producer and the consumers agree and every branch on it is uniform.
__device__ __forceinline__ int tile_taps(const Shape& s, int oy0, int ox0,
                                         uint64_t& list) {
  const int rows = min(kTH, s.ho - oy0), cols = min(kTW, s.wo - ox0);
  int n = 0;
  list = 0;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int iy = oy0 - s.pad_h + (tap / 3) * s.dil;
    const int ix = ox0 - s.pad_w + (tap % 3) * s.dil;
    if (iy < s.h && iy + rows > 0 && ix < s.w && ix + cols > 0) {
      list |= static_cast<uint64_t>(tap) << (4 * n);
      ++n;
    }
  }
  return n;
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
dilated_conv_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map,
                    __nv_bfloat16* __restrict__ out, const Shape s) {
  constexpr int S = stages_for(N);
  constexpr int SB = stage_bytes(N);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      smem_u32(smem_raw) + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bar = base + S * SB;
  auto full = [&](int st) { return bar + 8 * st; };
  auto empty = [&](int st) { return bar + 8 * (kMaxStages + st); };
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * kConsumers);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int per_image = s.tiles_x * s.tiles_y;

  if (tid >= 128 * kConsumers) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid != 128 * kConsumers) return;
    int it = 0;
    for (int t = blockIdx.x; t < s.tiles; t += gridDim.x) {
      const int b = t / per_image, rem = t % per_image;
      const int oy0 = rem / s.tiles_x * kTH, ox0 = rem % s.tiles_x * kTW;
      uint64_t list;
      const int n = tile_taps(s, oy0, ox0, list);
      for (int kc = 0; kc < s.chunks; ++kc)
        for (int j = 0; j < n; ++j, ++it) {
          const int tap = static_cast<int>((list >> (4 * j)) & 15);
          const int st = it % S;
          mbar_wait(empty(st), ((it / S) & 1) ^ 1);
          mbar_expect(full(st), SB);
          const uint32_t a = base + st * SB;
          tma_load4(a, &x_map, 64 * kc, ox0 - s.pad_w + (tap % 3) * s.dil,
                    oy0 - s.pad_h + (tap / 3) * s.dil, b, full(st));
          tma_load2(a + kABytes, &w_map, 64 * kc, tap * N, full(st));
        }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g8 = lane / 4, tq = lane % 4;  // accumulator row / column pair
  int it = 0;
  float acc[N / 2];
  for (int t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    const int b = t / per_image, rem = t % per_image;
    const int oy0 = rem / s.tiles_x * kTH, ox0 = rem % s.tiles_x * kTW;
    uint64_t list;
    const int n = tile_taps(s, oy0, ox0, list) * s.chunks;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    // the loop's trip count is uniform, so no product sits under a branch
    // ptxas cannot prove uniform (it would serialize them)
    for (int k = 0; k < n; ++k, ++it) {
      const int st = it % S;
      mbar_wait(full(st), (it / S) & 1);
      const uint32_t a = base + st * SB + wg * (kABytes / 2);
      const uint32_t w = base + st * SB + kABytes;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss<N>(acc, desc_sw128(a + ks * 32), desc_sw128(w + ks * 32));
      wgmma_commit();
      // the stage before this one has finished: back to the producer
      wgmma_wait<1>();
      if (k > 0 && lane == 0) mbar_arrive(empty((it - 1) % S));
    }
    wgmma_wait<0>();
    if (n > 0 && lane == 0) mbar_arrive(empty((it - 1) % S));

    // rows warp * 16 + g8 (+ 8) of this warpgroup's 64 pixels: tile row
    // 4 wg + warp, columns g8 and g8 + 8; columns 8 j + 2 tq (+ 1) of N
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int oy = oy0 + 4 * wg + warp, ox = ox0 + g8 + 8 * hr;
      if (oy < s.ho && ox < s.wo) {
        uint32_t* const o = reinterpret_cast<uint32_t*>(
            out + ((static_cast<size_t>(b) * s.ho + oy) * s.wo + ox) * N +
            2 * tq);
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          o[4 * j] = pack_bf16(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#endif
  }
  return fn;
}

// a map over a bf16 tensor of `rank` dims (innermost first, 64 of them in a
// box row: 128 B), 128B swizzle; out-of-bounds reads fill zero
bool make_map(CUtensorMap* map, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint32_t* box) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t strides[3];
  cuuint64_t stride = dims[0] * 2;
  for (int i = 1; i < rank; ++i) {
    strides[i - 1] = stride;
    stride *= dims[i];
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the current device's SM count, read once a device
int sm_count() {
  static int sms_of[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int& sms = sms_of[dev & 63];
  if (sms == 0) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <int N>
int launch(const CUtensorMap& xm, const CUtensorMap& wm, void* out,
           const Shape& s, cudaStream_t stream) {
  constexpr int smem = stages_for(N) * stage_bytes(N) + 2 * kMaxStages * 8 +
                       1024;
  static bool opted[64] = {};  // per device, once: the opt-in to 227 KB
  int dev = 0;
  cudaGetDevice(&dev);
  if (!opted[dev & 63]) {
    cudaFuncSetAttribute(dilated_conv_kernel<N>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    opted[dev & 63] = true;
  }
  const int sms = sm_count();
  dilated_conv_kernel<N><<<s.tiles < sms ? s.tiles : sms, kThreads, smem,
                           stream>>>(xm, wm,
                                     static_cast<__nv_bfloat16*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (batch, h, w, cin) bf16 NHWC; wp (9, cout, cin) bf16, tap 3 ky + kx;
// out (batch, ho, wo, cout) bf16 NHWC with ho = h + 2 pad_h - 2 dilation,
// wo = w + 2 pad_w - 2 dilation. Every pointer 16-byte aligned, cin a
// multiple of 8, cout one of 64, 128, 192, 256.
extern "C" int tpuseg_dilated_conv3x3(const void* x, const void* wp, void* out,
                                      int batch, int h, int w, int cin,
                                      int cout, int pad_h, int pad_w,
                                      int dilation, void* stream) {
  cudaGetLastError();  // start from a clean error state
  Shape s;
  s.batch = batch, s.h = h, s.w = w, s.cin = cin;
  s.pad_h = pad_h, s.pad_w = pad_w, s.dil = dilation;
  s.ho = h + 2 * pad_h - 2 * dilation;
  s.wo = w + 2 * pad_w - 2 * dilation;
  if (batch < 1 || h < 1 || w < 1 || cin < 8 || cin % 8 || dilation < 1 ||
      pad_h < 0 || pad_w < 0 || s.ho < 1 || s.wo < 1 ||
      (cout != 64 && cout != 128 && cout != 192 && cout != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  s.tiles_x = (s.wo + kTW - 1) / kTW;
  s.tiles_y = (s.ho + kTH - 1) / kTH;
  const long long tiles = static_cast<long long>(batch) * s.tiles_x *
                          s.tiles_y;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  s.tiles = static_cast<int>(tiles);
  s.chunks = (cin + 63) / 64;
  CUtensorMap xm, wm;
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(cin),
                               static_cast<cuuint64_t>(w),
                               static_cast<cuuint64_t>(h),
                               static_cast<cuuint64_t>(batch)};
  const cuuint32_t xbox[4] = {64, kTW, kTH, 1};
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(cin),
                               static_cast<cuuint64_t>(9 * cout)};
  const cuuint32_t wbox[2] = {64, static_cast<cuuint32_t>(cout)};
  if (!make_map(&xm, x, 4, xdims, xbox) || !make_map(&wm, wp, 2, wdims, wbox))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 64: return launch<64>(xm, wm, out, s, st);
    case 128: return launch<128>(xm, wm, out, s, st);
    case 192: return launch<192>(xm, wm, out, s, st);
    default: return launch<256>(xm, wm, out, s, st);
  }
}
