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
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16; ridge 295
// FLOP/byte): 2 (C M + 9 M^2 + M C) FLOP a pixel against 4 C bytes of x
// read and out written; at C = 4 M, 2.125 M FLOP a byte: (64, 16) 34 and
// (128, 32) 68 (pure streaming: bound by bytes), (512, 128) 272 (near the
// ridge) and (1024, 256) 544 (bound by operations).
//
// The design: persistent blocks, one an SM, walk rounds of output tiles in
// row-major order, so that neighbouring halos come from L2. A block is two
// or three consumer warpgroups and a producer warpgroup.
//   * Rounds: up to M = 128 each consumer takes an 8 x 8 tile of its own (a
//     round is two neighbours, or three: resident widths where three fit
//     and the input gives each block four rounds or more); past it (SPLIT)
//     two share one tile and split its channels: conv1 and conv2 by halves
//     of N, conv3 by halves of each 64-channel pass, t2 through shared
//     memory. So no accumulator passes 64 registers a thread: wider ones
//     made ptxas spill and serialize the products (note C7512).
//   * Registers: 168 a thread at launch (128 with three consumers); the
//     producer warpgroup drops to 40 and the consumers rise to 232 (152)
//     (setmaxnreg), which ptxas budgets the consumers' code by.
//   * The producer's thread 0 keeps two rings full behind full/empty
//     mbarriers. The x ring: the round's 10 x 10 halo windows of one
//     64-channel group (TMA, a 4-D map over NHWC, box 64 x 10 x 10, 128B
//     swizzle, 13 KB a window: rows 100-103 pad the second 64-row
//     product); TMA's out-of-bounds zero fill gives both the image border
//     and the channels past C (the map's channel extent is C). The weight
//     ring (streamed widths): the packed chunk each stage needs. Its thread
//     32 loads each conv3 pass's 8 x 8 residual box by TMA straight into
//     the consumer's output box (a ring of 2 a unit: a consumer, or the
//     SPLIT pair), where the epilogue adds it in place and one TMA
//     store, which clips the ragged edges and the channels past C, takes
//     the box out.
//   * The products: wgmma, bf16 operands, f32 accumulators in registers, N
//     = MP (M padded to 16; past 128 to 160, 192 or 256, the template
//     parameter), K padded to 16 by zero rows of the packed weights. conv1
//     m64nN1k16 over the window's 128 rows (rows >= 100 dropped), A = the
//     swizzled window, B = w1 (N1 = MP, or MP / 2 in two passes past 64);
//     conv2 m64nMPk16 (m64n(MP/2) a consumer under SPLIT) over the tile's
//     64 pixels, nine taps x MP / 16 k-steps, A = t1 in shared memory;
//     conv3 m64n64k16 a 64-channel pass, A = conv2's accumulator + b2,
//     ReLU, bf16 straight from registers (under SPLIT: m64n32k16 a
//     consumer, A = t2 in shared memory).
//   * t1, t2 and every packed weight are in wgmma's no-swizzle K-major
//     layout: planes of 8 channels, a pixel (or an output channel) a 16 B
//     row. So tap (dy, dx)'s A operand is a descriptor at t1 row 10 dy +
//     dx, 8-row groups 10 rows apart: no gather, any shift. No product sits
//     under a branch ptxas cannot prove uniform (note C7520).
//   * Weights by width class (choose_plan): resident up to MP = 48 where
//     the packed weights, the two consumers' buffers and a 3-slot x ring
//     fit in the 227 KB a block may use: (64, 16) 8.5 KB, (128, 32) 34 KB,
//     (96, 40) 65 KB, (192, 48) 77 KB; along C = 4 M, (224, 56) is the
//     first streamed width. One bulk copy a block at its start. Streamed
//     past that ((256, 64) 139 KB, (512, 128) 557 KB, (1024, 256) 2.2 MB):
//     chunks of <= 16 KB through the weight ring, read from L2, each
//     serving the round's 128 pixels (64 under SPLIT). A slot goes back to
//     the producer as soon as its products are done.
// Shared memory (bytes, from a 1024-aligned base; make_plan): the x ring
// (stages x 13 KB a tile of the round), the output boxes (8 KB each), the
// weight ring or the resident weights, the biases (f32), t1 (MP / 8 planes
// x 1600 B a tile), t2 (SPLIT: 128 MP), the mbarriers.
// What it still leaves on the table (PERF.md §6): conv1 recomputes the
// halo (128 rows for 64 pixels); a consumer's chain (conv1, its epilogue,
// conv2, conv3 and its epilogue) runs in series, hidden only by the other
// consumer, and the two take their x stages together; a streamed width
// brings every weight chunk from L2 for 128 pixels (64 under SPLIT).
//
// C interface (bound with ctypes by tpuseg_torch/kernels/_build.py): the
// launch returns cudaGetLastError(), launches on the given stream and
// allocates nothing; the pack is host code.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxC = 1024, kMaxM = 256;
constexpr int kSmemLimit = 232448;     // shared memory a block may use
constexpr int kTW = 8, kTH = 8;        // output tile
constexpr int kWW = kTW + 2;           // window width
constexpr int kWPix = 100;             // window pixels
constexpr int kWinSlot = 13 * 1024;    // one window group: 104 rows of 128 B
constexpr int kWinBytes = kWPix * 128;
constexpr int kBoxBytes = kTH * kTW * 128;  // an 8 x 8 x 64 box, 8 KB
constexpr int kPlane = kWPix * 16;     // a t1 plane: 100 pixels x 8 channels
constexpr int kMaxStages = 8;
constexpr int kBoxes = 2;  // output boxes a unit (a consumer, or SPLIT's pair)
// mbarriers: x full / empty, weight full / empty, the parameters, output
// box full / empty (2 units)
constexpr int kMaxUnits = 3;  // consumers with a tile each (resident: up to 3)
constexpr int kBars = 4 * kMaxStages + 1 + 2 * kMaxUnits * kBoxes;
// Consumer warpgroups (two, three with resident weights) and a producer
// warpgroup, 168 (128) registers a thread at launch; the producer gives
// its registers to the consumers (setmaxnreg, which ptxas budgets the
// consumers' code by: without it their products serialize for want of
// registers from MP = 64 on, note C7512)
constexpr int kProducerRegs = 40;
__host__ __device__ __forceinline__ constexpr int max_consumers(bool res) {
  return res ? 3 : 2;
}
__host__ __device__ __forceinline__ constexpr int consumer_regs(bool res) {
  return res ? 152 : 232;  // (65536 - 128 * 40) / (128 consumers), to 8
}

// M padded to the products' N (MP): to 16 up to 128, then 160, 192, 256
__host__ __device__ __forceinline__ constexpr int padded_width(int m) {
  return m <= 128 ? (m + 15) / 16 * 16 : m <= 160 ? 160 : m <= 192 ? 192 : 256;
}

// conv1's N a pass: MP up to 64, else MP / 2 in two passes (halved again
// between the consumers past kSplitMP), so that a consumer's two 64-row
// accumulators stay within 64 registers: ptxas spills and serializes the
// products of wider ones in a kernel of 384 threads
__host__ __device__ __forceinline__ constexpr int conv1_n(int mp) {
  return mp <= 64 ? mp : mp / 2;
}

// the widest MP whose weights may stay resident (instantiated so)
constexpr int kMaxResidentMP = 48;

// The K depth of a streamed w2 chunk (w3's: a slot's worth): 64, or 32
// past kSplitMP, so that a chunk stays within 16 KB and the weight ring
// holds 5 or more slots there, not 2 of 32 KB (slower)
__host__ __device__ __forceinline__ constexpr int w_depth(int mp) {
  return mp <= 128 ? 64 : 32;
}

// Past MP = 128 the two consumers split one tile's channels (SPLIT) in
// place of taking a tile each, so that no accumulator passes 64 registers
constexpr int kSplitMP = 128;

// One (C, M) and its layouts. Blob: the packed weights (w1, w2, w3 images)
// then the f32 biases; shared memory: offsets from the aligned base.
struct Plan {
  int mp, n1, cg;
  int resident, nwg, tpr, sx, sw;
  int xslot, wslot;
  int w2, w3, bias, bias_bytes, blob;
  int s_out, s_w, s_par, s_t1, t1b, s_t2, s_bar, smem;
};

__host__ __device__ inline Plan make_plan(int c, int m, int resident,
                                          int nwg) {
  Plan p;
  p.mp = padded_width(m);
  p.n1 = conv1_n(p.mp);
  p.cg = (c + 63) / 64;
  p.resident = resident;
  p.nwg = nwg;
  const bool split = p.mp > kSplitMP;
  p.tpr = split ? 1 : nwg;  // tiles a round
  // blob: w1 chunks (pass, group) of 128 N1 B, nine w2 taps of 2 MP^2 B,
  // w3 passes (64 output channels) of 128 MP B, then b1, b2 (MP) and b3
  // (64 CG) in f32; streamed, a w2 tap and a w3 pass go in chunks of
  // w_depth (w3: 64 / w_depth of them) input channels
  p.w2 = 128 * p.cg * p.mp;
  p.w3 = p.w2 + 9 * 2 * p.mp * p.mp;
  p.bias = p.w3 + p.cg * 128 * p.mp;
  p.bias_bytes = (2 * p.mp + 64 * p.cg) * 4;
  p.blob = p.bias + p.bias_bytes;
  // shared memory: the x ring first (the second 64-row product of the
  // last window reads past it, into the output boxes), then the rest
  p.xslot = p.tpr * kWinSlot;
  p.wslot = resident ? 0 : 2 * w_depth(p.mp) * p.mp;
  p.t1b = p.mp / 8 * kPlane;
  const int out = p.tpr * kBoxes * kBoxBytes;
  const int par = (resident ? p.bias : 0) + p.bias_bytes;
  const int t2 = split ? 128 * p.mp : 0;
  const int fixed = out + par + p.tpr * p.t1b + t2 + kBars * 8 + 16;
  const int avail = kSmemLimit - 1024 - fixed;
  if (resident) {
    p.sw = 0;
    p.sx = avail / p.xslot;
  } else {  // three x slots, or two where that buys a third weight slot
    p.sx = 3;
    p.sw = (avail - p.sx * p.xslot) / p.wslot;
    if (p.sw < 3 && (avail - 2 * p.xslot) / p.wslot >= 3) {
      p.sx = 2;
      p.sw = (avail - p.sx * p.xslot) / p.wslot;
    }
  }
  p.sx = p.sx < kMaxStages ? p.sx : kMaxStages;
  p.sw = p.sw < kMaxStages ? p.sw : kMaxStages;
  p.s_out = p.sx * p.xslot;
  p.s_w = p.s_out + out;
  p.s_par = p.s_w + p.sw * p.wslot;
  p.s_t1 = p.s_par + (par + 15) / 16 * 16;
  p.s_t2 = p.s_t1 + p.tpr * p.t1b;
  p.s_bar = p.s_t2 + t2;
  p.smem = p.s_bar + kBars * 8;
  return p;
}

// The host's choice for an input of `tiles` 8 x 8 tiles on `sms` SMs:
// resident weights (up to kMaxResidentMP) where a 3-slot x ring fits,
// three consumers or else two; else streamed, two consumers where a ring
// of 2 + 2 slots fits (always past kSplitMP), else one.
Plan choose_plan(int c, int m, long long tiles, int sms) {
  // three consumers only where each block gets at least four rounds of
  // three tiles: on fewer, rounds of three split unevenly over the SMs
  // (slower at (128, 32) on the 0.5x map, 512 tiles)
  const int most = tiles >= 4LL * 3 * sms ? max_consumers(true) : 2;
  for (int nwg = most; nwg >= 2; --nwg) {
    const Plan p = make_plan(c, m, 1, nwg);
    if (p.mp <= kMaxResidentMP && p.sx >= 3) return p;
  }
  Plan p = make_plan(c, m, 0, 2);
  if ((p.sx >= 2 && p.sw >= 2) || p.mp > kSplitMP) return p;
  return make_plan(c, m, 0, 1);
}

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

// wgmma descriptors. K-major, 128B swizzle (the TMA window): 8-row atoms
// 1024 B apart. K-major, no swizzle (t1 and the packed weights): 8 x 16 B
// core matrices, `lbo` bytes to the next 8 channels (K), `sbo` bytes to the
// next 8 rows (M or N).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ uint64_t desc_ns(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
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

// the 128 threads of consumer warpgroup `wg`
__device__ __forceinline__ void group_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// shared memory written by threads, next read by wgmma or a TMA store
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 256 threads of both consumer warpgroups
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 5, 256;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// wgmma m64nNk16 bf16 -> f32, A and B in shared memory: D (64 x N, N / 2
// registers a thread) += A . B, or = A . B where accumulate is 0. The
// operand lists are spelled 8 registers at a time.
#define WG_S0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_S(a, b, c, d, e, f, g, h) \
  ", %" #a ", %" #b ", %" #c ", %" #d ", %" #e ", %" #f ", %" #g ", %" #h
#define WG_S1 WG_S(8, 9, 10, 11, 12, 13, 14, 15)
#define WG_S2 WG_S(16, 17, 18, 19, 20, 21, 22, 23)
#define WG_S3 WG_S(24, 25, 26, 27, 28, 29, 30, 31)
#define WG_S4 WG_S(32, 33, 34, 35, 36, 37, 38, 39)
#define WG_S5 WG_S(40, 41, 42, 43, 44, 45, 46, 47)
#define WG_S6 WG_S(48, 49, 50, 51, 52, 53, 54, 55)
#define WG_S7 WG_S(56, 57, 58, 59, 60, 61, 62, 63)
#define WG_Q(a, b, c, d) ", %" #a ", %" #b ", %" #c ", %" #d
#define WG_R4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_R(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);

#define WGMMA_SS(N, IA, IB, IP, STR, ...)                                   \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_ss<N>(float (&d)[N / 2], uint64_t a, \
                                              uint64_t b, int acc) {        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IP ", 0;\n"           \
                 "wgmma.mma_async.sync.aligned.m64n" #N                      \
                 "k16.f32.bf16.bf16 {" STR "}, %" #IA ", %" #IB              \
                 ", p, 1, 1, 0, 0;\n}\n"                                     \
                 : __VA_ARGS__                                               \
                 : "l"(a), "l"(b), "r"(acc));                                \
  }

WGMMA_SS(16, 8, 9, 10, WG_S0, WG_R(0))
WGMMA_SS(32, 16, 17, 18, WG_S0 WG_S1, WG_R(0), WG_R(8))
WGMMA_SS(40, 20, 21, 22, WG_S0 WG_S1 WG_Q(16, 17, 18, 19), WG_R(0), WG_R(8),
         WG_R4(16))
WGMMA_SS(48, 24, 25, 26, WG_S0 WG_S1 WG_S2, WG_R(0), WG_R(8), WG_R(16))
WGMMA_SS(56, 28, 29, 30, WG_S0 WG_S1 WG_S2 WG_Q(24, 25, 26, 27), WG_R(0),
         WG_R(8), WG_R(16), WG_R4(24))
WGMMA_SS(64, 32, 33, 34, WG_S0 WG_S1 WG_S2 WG_S3, WG_R(0), WG_R(8),
         WG_R(16), WG_R(24))
WGMMA_SS(80, 40, 41, 42, WG_S0 WG_S1 WG_S2 WG_S3 WG_S4, WG_R(0), WG_R(8),
         WG_R(16), WG_R(24), WG_R(32))
WGMMA_SS(96, 48, 49, 50, WG_S0 WG_S1 WG_S2 WG_S3 WG_S4 WG_S5, WG_R(0),
         WG_R(8), WG_R(16), WG_R(24), WG_R(32), WG_R(40))
WGMMA_SS(112, 56, 57, 58, WG_S0 WG_S1 WG_S2 WG_S3 WG_S4 WG_S5 WG_S6,
         WG_R(0), WG_R(8), WG_R(16), WG_R(24), WG_R(32), WG_R(40), WG_R(48))
WGMMA_SS(128, 64, 65, 66, WG_S0 WG_S1 WG_S2 WG_S3 WG_S4 WG_S5 WG_S6 WG_S7,
         WG_R(0), WG_R(8), WG_R(16), WG_R(24), WG_R(32), WG_R(40), WG_R(48),
         WG_R(56))

// D (64 x N) += A . B, A (64 x 16) in registers, B in shared memory
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t b, int acc);

#define WGMMA_RS(N, A0, A1, A2, A3, IB, IP, STR, ...)                        \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_rs<N>(                              \
      float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int acc) {     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IP ", 0;\n"           \
                 "wgmma.mma_async.sync.aligned.m64n" #N                      \
                 "k16.f32.bf16.bf16 {" STR "}, {%" #A0 ", %" #A1 ", %" #A2   \
                 ", %" #A3 "}, %" #IB ", p, 1, 1, 0;\n}\n"                  \
                 : __VA_ARGS__                                               \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),       \
                   "r"(acc));                                                \
  }

WGMMA_RS(64, 32, 33, 34, 35, 36, 37, WG_S0 WG_S1 WG_S2 WG_S3, WG_R(0),
         WG_R(8), WG_R(16), WG_R(24))

template <int N>
struct Int {
  static constexpr int value = N;
};

// MP = M padded (the products' N); RESIDENT: the weights in shared memory.
// Up to max_consumers consumer warpgroups (choose_plan picks the count) and
// the producer warpgroup.
template <int MP, bool RESIDENT>
__global__ void __launch_bounds__(128 * max_consumers(RESIDENT) + 128, 1)
bottleneck_any_kernel(const __grid_constant__ CUtensorMap win_map,
                      const __grid_constant__ CUtensorMap res_map,
                      const __grid_constant__ CUtensorMap out_map,
                      const unsigned char* __restrict__ blob, const Plan p,
                      int batch, int h, int w) {
  constexpr bool SPLIT = MP > kSplitMP;     // the consumers share a tile
  constexpr int N1 = conv1_n(MP);           // conv1's N a pass
  constexpr int NP1 = MP / N1;              // conv1's passes
  constexpr int NC1 = SPLIT ? N1 / 2 : N1;  // a consumer's share of N1
  constexpr int NC2 = SPLIT ? MP / 2 : MP;  // a consumer's conv2 N
  constexpr int NC3 = SPLIT ? 32 : 64;      // a consumer's conv3 N a pass
  constexpr int KS = MP / 16;  // k-steps of conv2 (a tap) and of conv3
  constexpr int KD = w_depth(MP) / 16;  // k-steps of a streamed w2 chunk
  // a w3 pass (2 KB a k-step) in chunks of at most a slot, 2 w_depth MP B
  constexpr int D3 = KS < w_depth(MP) * MP / 1024 ? KS
                                                  : w_depth(MP) * MP / 1024;
  constexpr int W3H = (KS + D3 - 1) / D3;  // chunks a pass, of D3 k-steps
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar = base + p.s_bar;
  auto xfull = [&](int s) { return bar + 8 * s; };
  auto xempty = [&](int s) { return bar + 8 * (kMaxStages + s); };
  auto wfull = [&](int s) { return bar + 8 * (2 * kMaxStages + s); };
  auto wempty = [&](int s) { return bar + 8 * (3 * kMaxStages + s); };
  const uint32_t params_full = bar + 8 * (4 * kMaxStages);
  // output box k of unit u: holds pass n's residual, then its result
  auto ofull = [&](int u, int k) {
    return bar + 8 * (4 * kMaxStages + 1 + u * kBoxes + k);
  };
  auto oempty = [&](int u, int k) {
    return bar + 8 * (4 * kMaxStages + 1 + (kMaxUnits + u) * kBoxes + k);
  };
  const int tid = threadIdx.x, nwg = p.nwg, tpr = p.tpr;

  if (tid == 0) {
    for (int s = 0; s < p.sx; ++s) {
      mbar_init(xfull(s), 1);
      mbar_init(xempty(s), 4 * nwg);  // one arrival per consumer warp
    }
    for (int s = 0; s < p.sw; ++s) {
      mbar_init(wfull(s), 1);
      mbar_init(wempty(s), 4 * nwg);
    }
    mbar_init(params_full, 1);
    for (int u = 0; u < tpr; ++u)
      for (int k = 0; k < kBoxes; ++k) {
        mbar_init(ofull(u, k), 1);
        mbar_init(oempty(u, k), 1);  // the thread that stores the box
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // resident: the weight images and the biases; streamed: the biases
    const int from = RESIDENT ? 0 : p.bias;
    mbar_expect(params_full, p.blob - from);
    bulk_load(base + p.s_par, blob + from, p.blob - from, params_full);
  }
  __syncthreads();

  const int tiles_x = (w + kTW - 1) / kTW;
  const int per_image = tiles_x * ((h + kTH - 1) / kTH);
  const int tiles = batch * per_image;
  const int rounds = (tiles + tpr - 1) / tpr;

  if (tid >= 128 * nwg) {
    // ---------------------------------------------------------- producer
    // a warpgroup, for setmaxnreg; thread 0 issues the windows and the
    // weights, thread 32 the residual boxes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int role = tid - 128 * nwg;
    if (role != 0 && role != 32) return;
    auto coords = [&](int t, int& tb, int& ty, int& tx) {
      const int rem = t % per_image;
      tb = t / per_image;
      ty = rem / tiles_x * kTH;
      tx = rem % tiles_x * kTW;
    };
    if (role == 32) {
      // the residual boxes into each unit's ring of output boxes, pass
      // by pass for all units, the order the consumers take them in (unit
      // by unit, one unit's consumer would wait on the other's weight
      // slots); a unit without a tile gets an empty arrival
      int n = 0;
      for (int r = blockIdx.x; r < rounds; r += gridDim.x) {
        int tb[kMaxUnits], ty[kMaxUnits], tx[kMaxUnits];
        for (int u = 0; u < tpr; ++u) coords(r * tpr + u, tb[u], ty[u], tx[u]);
        for (int q = 0; q < p.cg; ++q, ++n)
          for (int u = 0; u < tpr; ++u) {
            const int k = n % kBoxes;
            mbar_wait(oempty(u, k), ((n / kBoxes) & 1) ^ 1);
            if (r * tpr + u < tiles) {
              mbar_expect(ofull(u, k), kBoxBytes);
              tma_load(base + p.s_out + (u * kBoxes + k) * kBoxBytes, &res_map,
                       64 * q, tx[u], ty[u], tb[u], ofull(u, k));
            } else {
              mbar_arrive(ofull(u, k));
            }
          }
      }
      return;
    }
    int ix = 0, iw = 0;
    auto x_stage = [&](uint32_t bytes) {  // -> the slot
      const int s = ix % p.sx;
      mbar_wait(xempty(s), ((ix / p.sx) & 1) ^ 1);
      mbar_expect(xfull(s), bytes);
      ++ix;
      return s;
    };
    auto w_stage = [&](int off, uint32_t bytes) {
      const int s = iw % p.sw;
      mbar_wait(wempty(s), ((iw / p.sw) & 1) ^ 1);
      mbar_expect(wfull(s), bytes);
      bulk_load(base + p.s_w + s * p.wslot, blob + off, bytes, wfull(s));
      ++iw;
    };
    for (int r = blockIdx.x; r < rounds; r += gridDim.x) {
      const int valid = min(tpr, tiles - r * tpr);
      int tb[kMaxUnits], ty[kMaxUnits], tx[kMaxUnits];
      for (int k = 0; k < valid; ++k) coords(r * tpr + k, tb[k], ty[k], tx[k]);
      for (int pass = 0; pass < NP1; ++pass)
        for (int g = 0; g < p.cg; ++g) {
          const int s = x_stage(valid * kWinBytes);
          for (int k = 0; k < valid; ++k)
            tma_load(base + s * p.xslot + k * kWinSlot, &win_map, 64 * g,
                     tx[k] - 1, ty[k] - 1, tb[k], xfull(s));
          if (!RESIDENT) w_stage((pass * p.cg + g) * 128 * N1, 128 * N1);
        }
      if (!RESIDENT) {
        for (int tap = 0; tap < 9; ++tap)
          for (int hh = 0; hh < (KS + KD - 1) / KD; ++hh)
            w_stage(p.w2 + tap * 2 * MP * MP + hh * KD * 32 * MP,
                    min(KD, KS - KD * hh) * 32 * MP);
        for (int q = 0; q < p.cg; ++q)
          for (int hh = 0; hh < W3H; ++hh)
            w_stage(p.w3 + q * 128 * MP + hh * D3 * 2048,
                    min(D3, KS - hh * D3) * 2048);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  // No product sits under a branch (ptxas serializes the wgmma of a kernel
  // that puts one on a path it cannot prove uniform, note C7520): a
  // consumer without a tile in the last round multiplies whatever its
  // slots hold and stores nothing.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                   consumer_regs(RESIDENT)));
  const int wg = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = tid % 32;
  const int g8 = lane / 4, tq = lane % 4;  // accumulator row / column pair
  // Accumulator rows warp * 16 + g8 (+ 8) all have row % 8 == g8, so in a
  // 128B-swizzled box the 16-byte chunk of column 8 * j + 2 * tq is
  // (j ^ g8) % 8: one XOR with this lane's constant.
  const uint32_t chunk_xor = g8 * 16;
  const uint32_t lane_at = (warp * 16 + g8) * 128 + tq * 4;
  // this consumer's tile slot, t1 and output boxes; under SPLIT one tile,
  // t1 and pair of boxes for both, and these column offsets
  const int mine = SPLIT ? 0 : wg;
  const int col1 = SPLIT ? wg * NC1 : 0, col2 = SPLIT ? wg * NC2 : 0;
  const int col3 = SPLIT ? wg * NC3 : 0;
  const uint32_t t1 = base + p.s_t1 + mine * p.t1b;
  const uint32_t wres = base + p.s_par;  // the resident weight images
  unsigned char* const outb = smem + p.s_out + mine * kBoxes * kBoxBytes;
  const bool storer = SPLIT ? tid == 0 : t == 0;  // issues the TMA stores
  auto out_sync = [&]() {  // the threads that share the output boxes
    if constexpr (SPLIT) consumers_sync();
    else group_sync(wg);
  };
  mbar_wait(params_full, 0);
  const float* b1 = reinterpret_cast<const float*>(
      smem + p.s_par + (RESIDENT ? p.bias : 0));
  const float* b2 = b1 + MP;
  const float* b3 = b1 + 2 * MP;
  int ix = 0, iw = 0, stores = 0;
  // a consumer warp is done with an x (and weight) slot
  auto release_x = [&](int i) {
    if (lane == 0) mbar_arrive(xempty(i % p.sx));
  };
  auto release_w = [&](int i) {
    if (!RESIDENT && lane == 0) mbar_arrive(wempty(i % p.sw));
  };
  auto wait_w = [&](int i) {  // weight stage i's address
    const int s = i % p.sw;
    mbar_wait(wfull(s), (i / p.sw) & 1);
    return base + p.s_w + s * p.wslot;
  };

  for (int r = blockIdx.x; r < rounds; r += gridDim.x) {
    const int tile = r * tpr + mine;
    const bool valid = tile < tiles;
    const int rem = tile % per_image;
    const int b = tile / per_image;
    const int y0 = rem / tiles_x * kTH, x0 = rem % tiles_x * kTW;

    // conv1 over the window, N1 columns a pass (NC1 of them this
    // consumer's) -> t1, zero outside the image. Every group runs 4
    // k-steps: past C the window (TMA's fill) and the w1 chunk (the pack)
    // hold zeros. A slot (x or weight) goes back to the producer as soon as
    // its products have finished: the other consumer keeps the tensor
    // cores busy meanwhile, and one more chunk is in flight than if it
    // were held until the next group's products are issued (faster at
    // every width, PERF.md §6).
#pragma unroll 1
    for (int pass = 0; pass < NP1; ++pass) {
      float acc1[2][NC1 / 2];
#pragma unroll 1
      for (int g = 0; g < p.cg; ++g) {
        const int s = ix % p.sx;
        mbar_wait(xfull(s), (ix / p.sx) & 1);
        const uint32_t wb =
            (RESIDENT ? wres + (pass * p.cg + g) * 128 * N1 : wait_w(iw)) +
            col1 * 16;
        const uint32_t a0 = base + s * p.xslot + mine * kWinSlot;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t db = desc_ns(wb + ks * 2 * N1 * 16, N1 * 16, 128);
          wgmma_ss<NC1>(acc1[0], desc_sw128(a0 + ks * 32), db,
                        g > 0 || ks > 0);
          wgmma_ss<NC1>(acc1[1], desc_sw128(a0 + 64 * 128 + ks * 32), db,
                        g > 0 || ks > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        release_x(ix);
        release_w(iw);
        ++ix;
        iw += !RESIDENT;
      }
      // t1 = relu(acc1 + b1), zero outside the image (the 3x3's padding),
      // into planes of 8 channels, a pixel a 16 B row
      const int c0 = pass * N1 + col1;
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = mb * 64 + warp * 16 + g8 + 8 * hr;
          const int gy = y0 - 1 + row / kWW, gx = x0 - 1 + row % kWW;
          const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
          if (row < kWPix) {
            unsigned char* const at = smem + p.s_t1 + mine * p.t1b +
                                      c0 / 8 * kPlane + row * 16 + tq * 4;
#pragma unroll
            for (int j = 0; j < NC1 / 8; ++j) {
              const float2 bb = *reinterpret_cast<const float2*>(
                  b1 + c0 + 8 * j + 2 * tq);
              float v0 = fmaxf(acc1[mb][4 * j + 2 * hr] + bb.x, 0.f);
              float v1 = fmaxf(acc1[mb][4 * j + 2 * hr + 1] + bb.y, 0.f);
              if (!inside) v0 = v1 = 0.f;
              *reinterpret_cast<uint32_t*>(at + j * kPlane) =
                  pack_bf16(v0, v1);
            }
          }
        }
    }
    fence_async_smem();
    out_sync();

    // conv2: tap (dy, dx) reads t1 from row 10 dy + dx, 8-row groups (the
    // tile's output rows) 10 rows apart; B = the tap's w2 image (NC2 of its
    // rows this consumer's), resident or in chunks through the weight
    // ring. (Every accumulator is declared in the loop that fills
    // it: wgmma reads it, so one declared outside would stay live through
    // the other products.)
    float acc2[NC2 / 2];
    // k-steps kk0 .. kk0 + n - 1 of one tap: A = t1 from row a0, B rows
    // from w0 (a chunk or the resident tap image)
    auto conv2_steps = [&](uint32_t a0, uint32_t w0, int kk0, int first,
                           auto n) {
#pragma unroll
      for (int ks = 0; ks < decltype(n)::value; ++ks)
        wgmma_ss<NC2>(acc2,
                      desc_ns(a0 + 2 * (kk0 + ks) * kPlane, kPlane, 160),
                      desc_ns(w0 + col2 * 16 + ks * 2 * MP * 16, MP * 16, 128),
                      !first || ks > 0);
    };
    if constexpr (RESIDENT) {
      wgmma_fence();
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap)
        conv2_steps(t1 + ((tap / 3) * kWW + tap % 3) * 16,
                    wres + p.w2 + tap * 2 * MP * MP, 0, tap == 0,
                    Int<KS>());
      wgmma_commit();
      wgmma_wait<0>();
    } else {
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t a0 = t1 + ((tap / 3) * kWW + tap % 3) * 16;
#pragma unroll 1
        for (int hh = 0; hh < KS / KD; ++hh) {
          const uint32_t wb = wait_w(iw);
          wgmma_fence();
          conv2_steps(a0, wb, KD * hh, tap == 0 && hh == 0, Int<KD>());
          wgmma_commit();
          wgmma_wait<0>();
          release_w(iw);
          ++iw;
        }
        if constexpr (KS % KD != 0) {  // the tap's last chunk, shallower
          const uint32_t wb = wait_w(iw);
          wgmma_fence();
          conv2_steps(a0, wb, KS / KD * KD, tap == 0 && KS < KD,
                      Int<KS % KD>());
          wgmma_commit();
          wgmma_wait<0>();
          release_w(iw);
          ++iw;
        }
      }
    }
    // t2 = relu(acc2 + b2) in bf16, conv3's A: its fragments straight from
    // the accumulator, or under SPLIT each consumer's half into shared
    // memory (planes of 8 channels, a pixel a 16 B row), read by wgmma (64
    // registers of fragments would serialize the products at MP = 256)
    uint32_t a3[SPLIT ? 1 : KS][4];
    if constexpr (SPLIT) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = warp * 16 + g8 + 8 * hr;
#pragma unroll
        for (int j = 0; j < NC2 / 8; ++j) {
          const float2 bb =
              *reinterpret_cast<const float2*>(b2 + col2 + 8 * j + 2 * tq);
          *reinterpret_cast<uint32_t*>(
              smem + p.s_t2 + ((col2 / 8 + j) * 64 + row) * 16 + tq * 4) =
              pack_bf16(fmaxf(acc2[4 * j + 2 * hr] + bb.x, 0.f),
                        fmaxf(acc2[4 * j + 2 * hr + 1] + bb.y, 0.f));
        }
      }
      fence_async_smem();
      consumers_sync();
    } else {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 2 * ks + (q >> 1), e = 2 * (q & 1);
          const float2 bb =
              *reinterpret_cast<const float2*>(b2 + 8 * j + 2 * tq);
          a3[ks][q] = pack_bf16(fmaxf(acc2[4 * j + e] + bb.x, 0.f),
                                fmaxf(acc2[4 * j + e + 1] + bb.y, 0.f));
        }
    }

    // conv3 in passes of 64 output channels (NC3 of them this consumer's):
    // + b3 + the residual, which the producer put in this pass's output
    // box, ReLU, bf16 in place, then one TMA store of the box
#pragma unroll 1
    for (int q = 0; q < p.cg; ++q, ++stores) {
      const int k = stores % kBoxes;
      float acc3[NC3 / 2];
#pragma unroll
      for (int hh = 0; hh < W3H; ++hh) {  // the pass's w3 chunks
        const uint32_t wb =
            (RESIDENT ? wres + p.w3 + q * 128 * MP + hh * D3 * 2048
                      : wait_w(iw + hh)) + col3 * 16;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D3; ++ks) {
          const int kk = hh * D3 + ks;  // compile-time once unrolled
          if (kk >= KS) break;
          const uint64_t db = desc_ns(wb + ks * 2 * 1024, 1024, 128);
          if constexpr (SPLIT)
            wgmma_ss<NC3>(acc3,
                          desc_ns(base + p.s_t2 + kk * 2 * 1024, 1024, 128),
                          db, kk > 0);
          else
            wgmma_rs<NC3>(acc3, a3[kk], db, kk > 0);
        }
      }
      wgmma_commit();
      mbar_wait(ofull(mine, k), (stores / kBoxes) & 1);
      wgmma_wait<0>();
      for (int hh = 0; hh < W3H; ++hh) release_w(iw + hh);
      iw += RESIDENT ? 0 : W3H;
      unsigned char* const o = outb + k * kBoxBytes + lane_at;
#pragma unroll
      for (int j = 0; j < NC3 / 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(
            b3 + 64 * q + col3 + 8 * j + 2 * tq);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          uint32_t* const at = reinterpret_cast<uint32_t*>(
              o + hr * 8 * 128 + (((col3 / 8 + j) * 16) ^ chunk_xor));
          const float2 x =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
          *at = pack_bf16(fmaxf(acc3[4 * j + 2 * hr] + bb.x + x.x, 0.f),
                          fmaxf(acc3[4 * j + 2 * hr + 1] + bb.y + x.y, 0.f));
        }
      }
      fence_async_smem();
      out_sync();
      if (storer) {
        // the box before this one goes back to the producer once its store
        // has read it
        if (valid) {
          tma_store(&out_map, smem_u32(outb + k * kBoxBytes), 64 * q, x0, y0,
                    b);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        } else {
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
        if (stores > 0) mbar_arrive(oempty(mine, (stores - 1) % kBoxes));
      }
    }
  }
  if (storer) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// a 4-D map over NHWC bf16 of c channels (dims innermost first: C, W, H,
// B), boxes of 64 channels x box_w x box_h, 128B swizzle; out-of-bounds
// reads (the border, the channels past c) fill zero, stores are clipped
bool make_map(CUtensorMap* map, const void* ptr, int batch, int h, int w,
              int c, int box_w, int box_h) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {c * 2ull, static_cast<cuuint64_t>(w) * c * 2,
                                 static_cast<cuuint64_t>(h) * w * c * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
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

long long tile_count(int batch, int h, int w) {
  return static_cast<long long>(batch) * ((h + kTH - 1) / kTH) *
         ((w + kTW - 1) / kTW);
}

template <int MP, bool RESIDENT>
int launch(const CUtensorMap& win, const CUtensorMap& res,
           const CUtensorMap& out, const void* blob, const Plan& p, int batch,
           int h, int w, cudaStream_t stream) {
  // per device, once: the opt-in to 227 KB of shared memory
  static bool opted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (!opted[dev & 63]) {
    cudaFuncSetAttribute(bottleneck_any_kernel<MP, RESIDENT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemLimit);
    opted[dev & 63] = true;
  }
  const int sms = sm_count();
  const long long rounds = (tile_count(batch, h, w) + p.tpr - 1) / p.tpr;
  bottleneck_any_kernel<MP, RESIDENT>
      <<<rounds < sms ? static_cast<int>(rounds) : sms, 128 * p.nwg + 128,
         p.smem + 1024, stream>>>(win, res, out,
                                  static_cast<const unsigned char*>(blob), p,
                                  batch, h, w);
  return static_cast<int>(cudaGetLastError());
}

bool takes(int c, int m) {
  return c % 8 == 0 && m % 8 == 0 && c >= 8 && m >= 8 && c <= kMaxC &&
         m <= kMaxM;
}

}  // namespace

// bytes of the packed block for (c, m); 0 if the kernel does not take it
extern "C" int tpuseg_bottleneck_any_param_bytes(int c, int m) {
  return takes(c, m) ? make_plan(c, m, 0, 1).blob : 0;
}

// the host's plan for (c, m), for logs and tests: {resident, consumer
// warpgroups, tiles a round, x ring stages, weight ring stages,
// shared-memory bytes, MP} on an input of batch x h x w on this device
extern "C" int tpuseg_bottleneck_any_plan(int c, int m, int batch, int h,
                                          int w, void* out) {
  if (!takes(c, m) || batch < 1 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = choose_plan(c, m, tile_count(batch, h, w), sm_count());
  const int v[7] = {p.resident, p.nwg, p.tpr, p.sx, p.sw, p.smem + 1024,
                    p.mp};
  memcpy(out, v, sizeof(v));
  return 0;
}

// The packed block, on the host, from the folded weights in host memory:
// w1 (c, m), w2 (9, m, m) tap-major (tap, in, out) and w3 (m, c) as bf16
// bits; b1, b2 (m) and b3 (c) f32. Each weight matrix becomes wgmma's B
// operand in the no-swizzle K-major layout: element (n, k) of a chunk with
// N rows at ((k / 8) N + n) 16 + (k % 8) 2 bytes; zero past m and c.
extern "C" int tpuseg_bottleneck_any_pack(const void* w1, const void* b1,
                                          const void* w2, const void* b2,
                                          const void* w3, const void* b3,
                                          int c, int m, void* blob) {
  if (!takes(c, m)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(c, m, 0, 1);
  const int mp = p.mp, n1 = p.n1;
  unsigned char* o = static_cast<unsigned char*>(blob);
  memset(o, 0, p.blob);
  const uint16_t* s1 = static_cast<const uint16_t*>(w1);
  const uint16_t* s2 = static_cast<const uint16_t*>(w2);
  const uint16_t* s3 = static_cast<const uint16_t*>(w3);
  auto put = [o](int at, int rows, int n, int k, uint16_t v) {
    memcpy(o + at + ((k / 8) * rows + n) * 16 + (k % 8) * 2, &v, 2);
  };
  for (int ci = 0; ci < c; ++ci)
    for (int mi = 0; mi < m; ++mi)
      put(((mi / n1) * p.cg + ci / 64) * 128 * n1, n1, mi % n1, ci % 64,
          s1[ci * m + mi]);
  for (int tap = 0; tap < 9; ++tap)
    for (int ki = 0; ki < m; ++ki)
      for (int ko = 0; ko < m; ++ko)
        put(p.w2 + tap * 2 * mp * mp, mp, ko, ki, s2[(tap * m + ki) * m + ko]);
  for (int mi = 0; mi < m; ++mi)
    for (int co = 0; co < c; ++co)
      put(p.w3 + (co / 64) * 128 * mp, 64, co % 64, mi, s3[mi * c + co]);
  memcpy(o + p.bias, b1, m * 4);
  memcpy(o + p.bias + mp * 4, b2, m * 4);
  memcpy(o + p.bias + 2 * mp * 4, b3, c * 4);
  return 0;
}

// x (batch, h, w, c) bf16 NHWC; blob the packed block of blob_bytes
// (tpuseg_bottleneck_any_pack) on the device; out like x. Every pointer
// 16-byte aligned, c and m multiples of 8, c <= 1024, m <= 256.
extern "C" int tpuseg_bottleneck_any(const void* x, const void* blob,
                                     int blob_bytes, void* out, int batch,
                                     int h, int w, int c, int m,
                                     void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (!takes(c, m) || batch < 1 || h < 1 || w < 1 ||
      tile_count(batch, h, w) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = choose_plan(c, m, tile_count(batch, h, w), sm_count());
  if (blob_bytes != p.blob) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap win, res, omap;
  if (!make_map(&win, x, batch, h, w, c, kWW, kWW) ||
      !make_map(&res, x, batch, h, w, c, kTW, kTH) ||
      !make_map(&omap, out, batch, h, w, c, kTW, kTH))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // resident weights are instantiated up to kMaxResidentMP
  switch (p.mp * 2 + p.resident) {
#define TPUSEG_ANY_CASE(MP, RES) \
  case MP * 2 + RES:             \
    return launch<MP, RES>(win, res, omap, blob, p, batch, h, w, st);
    TPUSEG_ANY_CASE(16, 1)
    TPUSEG_ANY_CASE(32, 1)
    TPUSEG_ANY_CASE(48, 1)
    TPUSEG_ANY_CASE(16, 0)
    TPUSEG_ANY_CASE(32, 0)
    TPUSEG_ANY_CASE(48, 0)
    TPUSEG_ANY_CASE(64, 0)
    TPUSEG_ANY_CASE(80, 0)
    TPUSEG_ANY_CASE(96, 0)
    TPUSEG_ANY_CASE(112, 0)
    TPUSEG_ANY_CASE(128, 0)
    TPUSEG_ANY_CASE(160, 0)
    TPUSEG_ANY_CASE(192, 0)
    TPUSEG_ANY_CASE(256, 0)
#undef TPUSEG_ANY_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
