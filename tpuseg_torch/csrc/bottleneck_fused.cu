// Fused eval-mode HRNet stage-1 Bottleneck for Hopper (sm_90a).
//
// Replaces the TPU kernel tpuseg/kernels/bottleneck_fused.py::fused_bottleneck
// (Pallas body _kernel). With each BN folded into its conv (fold_bn) it
// computes, for an NHWC bf16 image x with C = 4 * M channels,
//
//     t1  = bf16(relu(conv1x1(x, w1) + b1))            C -> M
//     t2  = bf16(relu(conv3x3(t1, w2) + b2))           M -> M, zero padding 1
//     out = bf16(relu(conv1x1(t2, w3) + b3 + x))       M -> C
//
// with bf16 operands and f32 accumulation: the math of the unfused block and
// of reference_bottleneck. The 3x3 reads ZERO at taps outside the image (the
// conv's padding of t1). The TPU kernel instead pads x and computes
// relu(0 * w1 + b1) = relu(b1) at those taps, which differs from the block at
// every image border when b1 > 0; this kernel does not copy that.
//
// What bounds it on the H100: tensor-core math and device-memory bytes are
// close. Per call at the 2.0x eval scale (x of 512 x 1024 x 256) the block is
// 73 GFLOP and at least 537 MB of input plus output; unfused, t1 and t2
// (67 MB each) make a further round trip through device memory.
//
// What the design does about it: one block of 8 warps per 8 x 16 output
// tile. The block loads the halo-1 input window (10 x 18 pixels x C) into
// shared memory once, computes t1 over the window and t2 over the tile into
// shared memory, and writes only the final tile: t1 and t2 never reach device
// memory. The three products run on the tensor cores through WMMA
// (16 x 16 x 16 bf16 fragments, f32 accumulators), the 3x3 as 9 shifted
// products: because the tile is 16 pixels wide, the A operand of every tap
// is 16 consecutive rows of the t1 window. Weights are read through L1/L2.
// The batch is the grid's z dimension and ragged H and W are masked at the
// window load and the final store. The TPU kernel's 8-aligned over-fetch
// (a Mosaic DMA restriction) is not carried over. wgmma and TMA are later
// work.
//
// C interface (bound with ctypes by tpuseg_torch/kernels/_build.py): launches
// on the given stream, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kTH = 8;                  // output tile rows
constexpr int kTW = 16;                 // output tile cols (one WMMA row tile)
constexpr int kWH = kTH + 2;            // halo-1 window rows
constexpr int kWW = kTW + 2;            // halo-1 window cols
constexpr int kWPix = kWH * kWW;        // 180 window pixels
constexpr int kWRows = 192;             // kWPix rounded up to 16
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct Layout {
  int xs, t1s, t2s;  // row strides (elements) of the window, t1 and t2
  size_t x_off, t1_off, t2_off, scr_off, bytes;
};

__host__ __device__ inline Layout make_layout(int c, int m) {
  Layout l;
  l.xs = c + 8;    // +8 staggers banks; 16-row tiles stay 32-byte aligned
  l.t1s = m + 16;  // every row is 32-byte aligned: the 3x3 taps start anywhere
  l.t2s = m + 16;
  l.x_off = 0;
  l.t1_off = l.x_off + static_cast<size_t>(kWRows) * l.xs * 2;
  l.t2_off = l.t1_off + static_cast<size_t>(kWRows) * l.t1s * 2;
  l.scr_off = l.t2_off + static_cast<size_t>(kTH * kTW) * l.t2s * 2;
  l.bytes = l.scr_off + static_cast<size_t>(kWarps) * 256 * sizeof(float);
  return l;
}

__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
                  const __nv_bfloat16* __restrict__ w3, const float* __restrict__ b3,
                  __nv_bfloat16* __restrict__ out, int h, int w, int c, int m) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(c, m);
  __nv_bfloat16* xwin = reinterpret_cast<__nv_bfloat16*>(smem + L.x_off);
  __nv_bfloat16* t1 = reinterpret_cast<__nv_bfloat16*>(smem + L.t1_off);
  __nv_bfloat16* t2 = reinterpret_cast<__nv_bfloat16*>(smem + L.t2_off);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* scr = reinterpret_cast<float*>(smem + L.scr_off) + warp * 256;

  const int bi = blockIdx.z;
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTW;
  const size_t img_off = static_cast<size_t>(bi) * h * w * c;

  // 1. halo-1 input window, zero outside the image and past kWPix
  const int vpp = c / 8;  // 16-byte vectors per pixel
  for (int i = tid; i < kWRows * vpp; i += kThreads) {
    const int r = i / vpp;
    const int v = i % vpp;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < kWPix) {
      const int gy = y0 - 1 + r / kWW;
      const int gx = x0 - 1 + r % kWW;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        val = *reinterpret_cast<const uint4*>(
            x + img_off + (static_cast<size_t>(gy) * w + gx) * c + v * 8);
    }
    *reinterpret_cast<uint4*>(xwin + r * L.xs + v * 8) = val;
  }
  __syncthreads();

  // 2. t1 = relu(window . w1 + b1) over the window; 0 outside the image
  const int mt = m / 16;
  for (int tile = warp; tile < (kWRows / 16) * mt; tile += kWarps) {
    const int rt = tile / mt;
    const int ct = tile % mt;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < c / 16; ++kk) {
      FragA a;
      FragB b;
      wmma::load_matrix_sync(a, xwin + rt * 16 * L.xs + kk * 16, L.xs);
      wmma::load_matrix_sync(b, w1 + kk * 16 * m + ct * 16, m);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = rt * 16 + e / 16;
      const int j = ct * 16 + e % 16;
      float v = 0.f;
      if (r < kWPix) {
        const int gy = y0 - 1 + r / kWW;
        const int gx = x0 - 1 + r % kWW;
        if (gy >= 0 && gy < h && gx >= 0 && gx < w) v = fmaxf(scr[e] + b1[j], 0.f);
      }
      t1[r * L.t1s + j] = __float2bfloat16(v);
    }
    __syncwarp();
  }
  __syncthreads();

  // 3. t2 = relu(conv3x3(t1) + b2): per output row, 9 shifted products
  for (int tile = warp; tile < kTH * mt; tile += kWarps) {
    const int py = tile / mt;
    const int ct = tile % mt;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      const __nv_bfloat16* arow = t1 + ((py + dy) * kWW + dx) * L.t1s;
      const __nv_bfloat16* wtap = w2 + static_cast<size_t>(tap) * m * m;
      for (int kk = 0; kk < mt; ++kk) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, arow + kk * 16, L.t1s);
        wmma::load_matrix_sync(b, wtap + kk * 16 * m + ct * 16, m);
        wmma::mma_sync(acc, a, b, acc);
      }
    }
    wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int px = e / 16;
      const int j = ct * 16 + e % 16;
      t2[(py * kTW + px) * L.t2s + j] = __float2bfloat16(fmaxf(scr[e] + b2[j], 0.f));
    }
    __syncwarp();
  }
  __syncthreads();

  // 4. out = relu(t2 . w3 + b3 + x), stored for in-image pixels only
  const int ctn = c / 16;
  for (int tile = warp; tile < kTH * ctn; tile += kWarps) {
    const int py = tile / ctn;
    const int ct = tile % ctn;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < mt; ++kk) {
      FragA a;
      FragB b;
      wmma::load_matrix_sync(a, t2 + py * kTW * L.t2s + kk * 16, L.t2s);
      wmma::load_matrix_sync(b, w3 + kk * 16 * c + ct * 16, c);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
    __syncwarp();
    const int gy = y0 + py;
    for (int e = lane; e < 256; e += 32) {
      const int px = e / 16;
      const int j = ct * 16 + e % 16;
      const int gx = x0 + px;
      if (gy < h && gx < w) {
        const float res = __bfloat162float(xwin[((py + 1) * kWW + px + 1) * L.xs + j]);
        const float v = fmaxf(scr[e] + b3[j] + res, 0.f);
        out[img_off + (static_cast<size_t>(gy) * w + gx) * c + j] = __float2bfloat16(v);
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int tpuseg_bottleneck_smem_bytes(int c, int m) {
  return static_cast<int>(make_layout(c, m).bytes);
}

extern "C" int tpuseg_bottleneck(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* w3,
                                 const void* b3, void* out, int batch, int h,
                                 int w, int c, int m, void* stream) {
  cudaGetLastError();  // start from a clean error state
  const size_t smem = make_layout(c, m).bytes;
  cudaFuncSetAttribute(bottleneck_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, batch);
  bottleneck_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<const __nv_bfloat16*>(w3), static_cast<const float*>(b3),
      static_cast<__nv_bfloat16*>(out), h, w, c, m);
  return static_cast<int>(cudaGetLastError());
}
