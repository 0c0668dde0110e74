// Fused eval-mode HRNet stage-1 Bottleneck for Hopper (sm_90a).
//
// Replaces the TPU kernel tpuseg/kernels/bottleneck_fused.py::fused_bottleneck
// (pallas_call at :118, Pallas body _kernel). With each BN folded into its
// conv (fold_bn) it computes, for an NHWC bf16 image x with C = 256 = 4 * M
// channels (HRNet's stage-1 identity block, M = 64),
//
//     t1  = bf16(relu(conv1x1(x, w1) + b1))            C -> M
//     t2  = bf16(relu(conv3x3(t1, w2) + b2))           M -> M, zero padding 1
//     out = bf16(relu(conv1x1(t2, w3) + b3 + x))       M -> C
//
// with bf16 operands and f32 accumulation: the math of the unfused block and
// of reference_bottleneck. The 3x3 reads ZERO at taps outside the image (the
// conv's padding of t1): t1 is masked to 0 there explicitly. The TPU kernel
// instead computes relu(0 * w1 + b1) = relu(b1) at those taps, which differs
// from the block at every image border when b1 > 0; this kernel does not
// copy that (ROADMAP Queue 3).
//
// What bounds it on the H100: device-memory bytes. At the 1.0x eval scale
// (x of 256 x 512 x 256 bf16) x and out are 134 MB, 0.040 ms at 3.35 TB/s;
// the 18.3 GFLOP of the three products take 0.018 ms at 989 TFLOP/s.
//
// What the design does about it: one persistent block an SM (grid =
// min(tiles, SMs)) walks 8 x 8 output tiles in row-major order, so that
// neighbouring tiles' halos are read from L2. A block is one producer warp
// and one consumer warpgroup (160 threads).
//   * The weights live in shared memory for the whole kernel, in the
//     K-major 128B-swizzled layout wgmma reads: w1 32 KB + w2 72 KB + w3
//     32 KB, and the biases. tpuseg_bottleneck_pack (below, the one owner
//     of that layout) packs them into that image on the host once per
//     weight state (pack_weights); each block fetches it with one bulk
//     copy. No weight byte is read from device memory in the loop.
//   * The producer warp streams each tile's 10 x 10 halo window through TMA
//     (a 4-D tensor map over NHWC, box 64 channels x 10 x 10, 128B swizzle),
//     one 64-channel group (12.8 KB) at a time, into a ring of 3 slots with
//     full/empty mbarriers. TMA's out-of-bounds zero fill is x's zero halo.
//     The next tile's first groups are in flight while the consumer runs
//     conv2, conv3 and the epilogue.
//   * conv1: wgmma m64n64k16, A = the window rows straight from the ring slot
//     (the TMA's swizzled layout), B = resident w1; 2 x 64 rows cover the
//     100 window pixels (rows >= 100 are dropped), depth 256 = 4 slots. A
//     slot is released when the next group's products are issued and its
//     own have finished. While a group's products run, the window's 8 x 8
//     interior (the residual) is copied from its slot into the output
//     buffer. Epilogue + b1, ReLU, zero outside the image, bf16 into t1
//     (12.5 KB).
//   * conv2: 9 taps x 4 k-steps of wgmma m64n64k16 with A from registers: a
//     one-pixel shift breaks the swizzle phase of a descriptor, so each tap's
//     shifted t1 rows are gathered with ldmatrix (conflict-free, t1 rows are
//     XOR-swizzled) into one of two register buffers while the previous
//     tap's products run. B = the resident w2 tap.
//   * conv3: the conv2 accumulator + b2, ReLU, bf16 is, fragment for
//     fragment, the A operand of wgmma m64n64k16, one quarter of the 256
//     output channels at a time; t2 never reaches shared memory.
//   * Epilogue: per quarter, while the next quarter's products run, + b3 +
//     the residual, ReLU, bf16 written back in place in the output buffer
//     (every residual load of a quarter before its first store, and the
//     biases read as float2, so the loads are not serialized behind the
//     stores); then one TMA store of 4 boxes, which clips the ragged right
//     and bottom edges. The next tile waits for that store to have read the
//     buffer only when it is about to copy its own residual there.
// Shared memory: 137.5 KB parameters + 3 x 13 KB ring + 32 KB output +
// 12.5 KB t1 = 222.6 KB, with the 1 KB alignment slack of the 227 KB a
// block may use. What still holds it back (PERF.md §6): one consumer warp
// per scheduler hides no latency, so the warpgroup's chain (conv1, its
// epilogue, conv2, conv3 and its epilogue) runs nearly in series; and while
// it runs conv2 and conv3 the ring holds at most 3 of the next tile's 4
// groups, so loads and compute overlap only in part.
//
// C interface (bound with ctypes by tpuseg_torch/kernels/_build.py): launches
// on the given stream, allocates nothing, returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kC = 256;                // channels in and out
constexpr int kM = 64;                 // bottleneck width
constexpr int kTH = 8, kTW = 8;        // output tile
constexpr int kWH = kTH + 2, kWW = kTW + 2;
constexpr int kWPix = kWH * kWW;       // 100 window pixels
constexpr int kGroups = kC / 64;       // 64-channel (128-byte) groups
constexpr int kStages = 3;             // window ring slots
constexpr int kThreads = 160;          // consumer warpgroup + producer warp

// shared-memory map (bytes); every operand base is 1024-aligned. The
// parameter block [0, kParamBytes) is the image that tpuseg_bottleneck_pack
// writes.
constexpr int kW1 = 0;                               // 4 k-blocks x 64 rows
constexpr int kW2 = kW1 + kGroups * kM * 128;        // 9 taps x 64 rows
constexpr int kW3 = kW2 + 9 * kM * 128;              // 256 rows
constexpr int kBias = kW3 + kC * 128;                // b1, b2, b3 f32
constexpr int kParamBytes = kBias + (kM + kM + kC) * 4;
constexpr int kSlot = 13 * 1024;                     // 100 rows, 1024-aligned
constexpr int kRing = (kParamBytes + 1023) / 1024 * 1024;
constexpr int kOut = kRing + kStages * kSlot;        // 4 groups x 64 rows
constexpr int kT1 = kOut + kGroups * 64 * 128;       // 100 rows x 128 B
constexpr int kBar = kT1 + kWPix * 128;              // mbarriers
constexpr int kSmem = kBar + (2 * kStages + 1) * 8;
constexpr int kSmemAlloc = kSmem + 1024;             // base alignment slack
constexpr uint32_t kWinBytes = kWPix * 128;          // one group's window

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element k of row r in a K-major 128B-swizzled tile
__host__ __device__ __forceinline__ uint32_t sw128(int r, int k) {
  return static_cast<uint32_t>(r * 128 + ((((k >> 3) ^ r) & 7) << 4) +
                               (k & 7) * 2);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// a wait that never ends (a protocol fault) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 28)) __trap();
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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c, int x, int y, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(b),
      "r"(bar)
      : "memory");
}

// a contiguous bulk copy global -> shared, completion on an mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c, int x, int y, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c), "r"(x), "r"(y), "r"(b)
      : "memory");
}

// wgmma matrix descriptor: K-major, 128B swizzle, 8-row atoms 1024 B apart
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
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

__device__ __forceinline__ void consumer_sync() {  // the 128 consumer threads
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D (64 x 64) += A . B, A and B in shared memory (K-major, 128B swizzle)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64) += A . B, A in registers, B in shared memory (K-major, 128B
// swizzle)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__global__ void __launch_bounds__(kThreads, 1)
bottleneck_kernel(const __grid_constant__ CUtensorMap xwin_map,
                  const __grid_constant__ CUtensorMap out_map,
                  const void* __restrict__ params, int batch, int h, int w) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-aligned (the 128B swizzle's atom), as an offset from smem_raw so
  // that the compiler keeps shared-memory loads and stores
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar = base + kBar;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (kStages + s); };
  const uint32_t params_full = bar + 8 * (2 * kStages);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // one arrival per consumer warp
    }
    mbar_init(params_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the resident weights and biases: one bulk copy of the packed block
    mbar_expect(params_full, kParamBytes);
    bulk_load(base, params, kParamBytes, params_full);
  }
  __syncthreads();
  const float* bias = reinterpret_cast<const float*>(smem + kBias);

  const int tiles_x = (w + kTW - 1) / kTW;
  const int tiles_y = (h + kTH - 1) / kTH;
  const int per_image = tiles_x * tiles_y;
  const int tiles = batch * per_image;

  if (tid >= 128) {
    // ---------------------------------------------------------- producer
    if (tid != 128) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int b = tile / per_image, r = tile % per_image;
      const int y0 = (r / tiles_x) * kTH, x0 = (r % tiles_x) * kTW;
      for (int g = 0; g < kGroups; ++g, ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect(full(s), kWinBytes);
        tma_load(base + kRing + s * kSlot, &xwin_map, g * 64, x0 - 1, y0 - 1,
                 b, full(s));
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumer
  const int warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, tq = lane % 4;  // accumulator row / column pair
  // Accumulator rows warp * 16 + g8 (+ 8) all have row % 8 == g8, so in a
  // 128B-swizzled tile the 16-byte chunk of column 8 * j + 2 * tq is
  // (j ^ g8) % 8: one XOR with this lane's constant.
  const uint32_t chunk_xor = g8 * 16;
  const uint32_t lane_at = (warp * 16 + g8) * 128 + tq * 4;
  const int copy_chunk = tid % 8, copy_px = tid / 8;  // residual copy
  const int copy_row = (copy_px / kTW + 1) * kWW + copy_px % kTW + 1;
  const uint32_t copy_to = kOut + copy_px * 128 + ((copy_chunk ^ copy_px) & 7) * 16;
  mbar_wait(params_full, 0);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / per_image, r = tile % per_image;
    const int y0 = (r / tiles_x) * kTH, x0 = (r % tiles_x) * kTW;

    // conv1 over the window: rows 0-63 and 64-127 (>= 100 are dropped).
    // A slot goes back to the producer once the group after it is issued
    // and its own has finished.
    float acc1[2][32];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int s = (it + g) % kStages;
      mbar_wait(full(s), ((it + g) / kStages) & 1);
      const uint32_t a0 = base + kRing + s * kSlot;
      const uint32_t w0 = base + kW1 + g * kM * 128;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_ss_n64(acc1[0], desc(a0 + ks * 32), desc(w0 + ks * 32),
                     g > 0 || ks > 0);
        wgmma_ss_n64(acc1[1], desc(a0 + 64 * 128 + ks * 32),
                     desc(w0 + ks * 32), g > 0 || ks > 0);
      }
      wgmma_commit();
      if (g == 0) {
        // the last tile's output store has read the output buffer
        if (tid == 0)
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        consumer_sync();
      }
      // while the products run: the window's 8 x 8 interior, the residual,
      // into the output buffer. This thread copies 16-byte chunk tid % 8 of
      // pixels tid / 8 + 16 * k, i.e. window rows copy_row + 20 * k.
      uint4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = copy_row + 20 * k;
        v[k] = *reinterpret_cast<const uint4*>(
            smem + kRing + s * kSlot + r * 128 + ((copy_chunk ^ r) & 7) * 16);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        *reinterpret_cast<uint4*>(smem + copy_to + g * 64 * 128 +
                                  k * 16 * 128) = v[k];
      if (g > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty((it + g - 1) % kStages));
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty((it + kGroups - 1) % kStages));
    it += kGroups;
    // this lane's bias pairs, columns 8 * j + 2 * tq: b1 and b2
    float2 b1v[8], b2v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      b1v[j] = reinterpret_cast<const float2*>(bias)[4 * j + tq];
      b2v[j] = reinterpret_cast<const float2*>(bias + kM)[4 * j + tq];
    }
    consumer_sync();  // every warp is done reading the last tile's t1
    // t1 = relu(acc1 + b1), zero outside the image (the 3x3's padding)
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = mb * 64 + warp * 16 + g8 + 8 * hr;
        const int gy = y0 - 1 + row / kWW, gx = x0 - 1 + row % kWW;
        const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
        unsigned char* const t1 = smem + kT1 + (mb * 64 + 8 * hr) * 128 + lane_at;
        if (row < kWPix) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float v0 = fmaxf(acc1[mb][4 * j + 2 * hr] + b1v[j].x, 0.f);
            float v1 = fmaxf(acc1[mb][4 * j + 2 * hr + 1] + b1v[j].y, 0.f);
            if (!inside) v0 = v1 = 0.f;
            *reinterpret_cast<uint32_t*>(t1 + ((j * 16) ^ chunk_xor)) =
                pack_bf16(v0, v1);
          }
        }
      }
    consumer_sync();

    // conv2: per tap, the shifted t1 rows gathered into A registers; two
    // register buffers, so the next tap's gather overlaps this tap's wgmma
    float acc2[32];
    const int pix = warp * 16 + (lane & 15);  // this lane's ldmatrix row
    const int py = pix / kTW, px = pix % kTW;
    uint32_t a[2][4][4];
    auto gather = [&](int tap, uint32_t (&r)[4][4]) {
      const int trow = (py + tap / 3) * kWW + px + tap % 3;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        ldsm_x4(r[ks], base + kT1 + sw128(trow, 16 * ks + 8 * (lane >> 4)));
    };
    gather(0, a[0]);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t w0 = base + kW2 + tap * kM * 128;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_rs_n64(acc2, a[tap & 1][ks], desc(w0 + ks * 32),
                     tap > 0 || ks > 0);
      wgmma_commit();
      if (tap < 8) {
        if (tap > 0) wgmma_wait<1>();  // tap - 1 has released its buffer
        gather(tap + 1, a[(tap + 1) & 1]);
      }
    }
    wgmma_wait<0>();
    // t2 = relu(acc2 + b2) in bf16: the A fragments of conv3
    uint32_t a3[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 2 * ks + (q >> 1), e = 2 * (q & 1);
        a3[ks][q] = pack_bf16(fmaxf(acc2[4 * j + e] + b2v[j].x, 0.f),
                              fmaxf(acc2[4 * j + e + 1] + b2v[j].y, 0.f));
      }

    // conv3 in quarters of 64 output channels (the output buffer's groups),
    // two in flight: a quarter's epilogue, + b3 + x, ReLU, bf16 in place,
    // runs while the next quarter's products do
    float acc3[2][32];
    auto conv3 = [&](int q) {
      const uint32_t w0 = base + kW3 + q * 64 * 128;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_rs_n64(acc3[q & 1], a3[ks], desc(w0 + ks * 32), ks > 0);
      wgmma_commit();
    };
    conv3(0);
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      // this lane's residual pairs (rows warp * 16 + g8 + 8 * hr, columns
      // q * 64 + 8 * j + 2 * tq), all loaded before any store
      unsigned char* const o = smem + kOut + q * 64 * 128 + lane_at;
      uint32_t res[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          res[j][hr] = *reinterpret_cast<const uint32_t*>(
              o + hr * 8 * 128 + ((j * 16) ^ chunk_xor));
      const float2* b3v = reinterpret_cast<const float2*>(bias + 2 * kM + q * 64);
      if (q + 1 < kGroups) {
        conv3(q + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 b3 = b3v[4 * j + tq];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&res[j][hr]));
          *reinterpret_cast<uint32_t*>(o + hr * 8 * 128 + ((j * 16) ^ chunk_xor)) =
              pack_bf16(fmaxf(acc3[q & 1][4 * j + 2 * hr] + b3.x + x.x, 0.f),
                        fmaxf(acc3[q & 1][4 * j + 2 * hr + 1] + b3.y + x.y, 0.f));
        }
      }
    }
    // the output tile to device memory; TMA clips the ragged edges. The
    // next tile waits for the store to have read the buffer before it
    // writes its residual there.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync();
    if (tid == 0) {
      for (int g = 0; g < kGroups; ++g)
        tma_store(&out_map, base + kOut + g * 64 * 128, g * 64, x0, y0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// a 4-D map over NHWC bf16 (dims innermost first: C, W, H, B), 128B swizzle
bool make_map(CUtensorMap* map, const void* ptr, int batch, int h, int w,
              int box_w, int box_h) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {kC, static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {kC * 2ull, static_cast<cuuint64_t>(w) * kC * 2,
                                 static_cast<cuuint64_t>(h) * w * kC * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" int tpuseg_bottleneck_param_bytes() { return kParamBytes; }

// The parameter block, packed on the host into blob (kParamBytes) from the
// folded weights in host memory: w1 (C, M), w2 (9, M, M) tap-major (tap,
// in, out) and w3 (M, C) as bf16 bits; b1, b2, b3 f32. Each weight matrix
// becomes wgmma's B operand: row n = output channel, its input channels in
// 64-deep blocks of 128-byte rows, 16-byte chunks XOR-swizzled (sw128).
extern "C" int tpuseg_bottleneck_pack(const void* w1, const void* b1,
                                      const void* w2, const void* b2,
                                      const void* w3, const void* b3,
                                      void* blob) {
  unsigned char* p = static_cast<unsigned char*>(blob);
  const uint16_t* s1 = static_cast<const uint16_t*>(w1);
  const uint16_t* s2 = static_cast<const uint16_t*>(w2);
  const uint16_t* s3 = static_cast<const uint16_t*>(w3);
  auto put = [p](int at, int row, int k, uint16_t v) {
    memcpy(p + at + sw128(row, k), &v, 2);
  };
  for (int ci = 0; ci < kC; ++ci)
    for (int mi = 0; mi < kM; ++mi)
      put(kW1 + (ci / 64) * kM * 128, mi, ci % 64, s1[ci * kM + mi]);
  for (int tap = 0; tap < 9; ++tap)
    for (int ki = 0; ki < kM; ++ki)
      for (int ko = 0; ko < kM; ++ko)
        put(kW2 + tap * kM * 128, ko, ki, s2[(tap * kM + ki) * kM + ko]);
  for (int mi = 0; mi < kM; ++mi)
    for (int co = 0; co < kC; ++co)
      put(kW3, co, mi, s3[mi * kC + co]);
  memcpy(p + kBias, b1, kM * 4);
  memcpy(p + kBias + kM * 4, b2, kM * 4);
  memcpy(p + kBias + 2 * kM * 4, b3, kC * 4);
  return 0;
}

extern "C" int tpuseg_bottleneck(const void* x, const void* params, void* out,
                                 int batch, int h, int w, void* stream) {
  cudaGetLastError();  // start from a clean error state
  CUtensorMap xwin, omap;
  if (!make_map(&xwin, x, batch, h, w, kWW, kWH) ||
      !make_map(&omap, out, batch, h, w, kTW, kTH))
    return static_cast<int>(cudaErrorInvalidValue);
  // per device, once: the SM count, and the opt-in to 227 KB of shared memory
  static int sms_of[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int& sms = sms_of[dev & 63];
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(bottleneck_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemAlloc);
  }
  const int tiles = batch * ((h + kTH - 1) / kTH) * ((w + kTW - 1) / kTW);
  bottleneck_kernel<<<tiles < sms ? tiles : sms, kThreads, kSmemAlloc,
                      static_cast<cudaStream_t>(stream)>>>(xwin, omap, params,
                                                           batch, h, w);
  return static_cast<int>(cudaGetLastError());
}
