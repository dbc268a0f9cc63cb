// Weight gradient of a stride-1 VALID conv with a tiny C_out, for Hopper
// (sm_90a):
//
//   dW[i,j,ci,co] = sum_{b,h,w} x_pad[b,h+i,w+j,ci] * dy[b,h,w,co]
//
// x_pad (B, Hp, Wp, Cin) and dy (B, Hp-k+1, Wp-k+1, Cout) are NHWC and
// contiguous, both bf16 or both f32; products and sums are f32 and the
// output is (k, k, Cin, Cout) f32. 1 <= Cout <= 8, any Hp, Wp >= k.
//
// Replaces: pcgan_tpu/ops/pallas_wgrad.py, conv_wgrad_lowcout (kernel body
// _wgrad_kernel). The TPU kernel zero-embeds the cotangent so that every
// tap's window is a plain slice, and streams each x tile once through the
// MXU; the bf16 route below keeps both ideas and lays them out for the
// tensor cores.
//
// Bound: bytes. At the G tail of the default step (x_pad (16, 134, 134, 64)
// bf16, dy (16, 128, 128, 3), k 7) the function moves ~38.4 MB: 0.0115 ms
// at 3.35 TB/s, against 4.93 GFLOP (5.6 GFLOP with N padded to n8 tiles),
// 0.005-0.006 ms on the 989 TFLOP/s bf16 tensor cores.
//
// bf16 route (wgrad_tc_kernel): with hh = h+i and ww = w+j,
//
//   dW^T[ci, n] = sum_p X[p, ci] * D[p, n],   n = (i, j, co),
//   D[(b,hh,ww), n] = dy[b, hh-i, ww-j, co]   (0 outside [0,H) x [0,W))
//
// is one GEMM of M = Cin, N = k*k*Cout, K = the pixels p of x_pad, so x is
// read from device memory once, and D is an im2col of the cotangent (C_out
// wide), never of x. mma.sync m16n8k16 bf16 -> f32: the products are exact
// in f32, the TPU kernel's numerics for bf16 input.
//   - Work items are (segment of one x_pad row, row), segment-major: a row
//     of Wp pixels splits into nseg = ceil(Wp / cap) segments of seg_w =
//     ceil(Wp / nseg) rounded up to 16 pixels, cap 160 halved while the
//     shared memory does not fit (one segment of 144 at the G tail). Block
//     x of gx = SMs / (gridDim.y * gridDim.z) takes the contiguous item
//     range [x*items/gx, (x+1)*items/gx) (it may cross images), 64 input
//     channels (gridDim.y) and a range of n8 tiles (gridDim.z).
//   - The block is warp-specialized: 4 producer warps fill a pipeline of 4
//     items, 8 MMA warps consume it; per stage a full and an empty
//     mbarrier, so neither side waits on a block-wide barrier.
//   - A: one TMA copy per item brings the (seg_w pixels, 64 ci) x tile,
//     zero past the row and past Cin, in the 128-byte swizzle (16-byte ci
//     chunk c of pixel p at c ^ (p mod 8); an unswizzled 128-byte pixel
//     would put eight pixels of a chunk on the same banks); ldmatrix.trans
//     reads it as rows of ci. Without 16-byte rows (Cin % 8 != 0) the
//     producers copy it in the same layout.
//   - B: a ring of k+3 dy rows, each kept as k shifted copies
//     ring[slot][j][co][q] = dy[b, r, w0+q-j, co] (zero outside), so every
//     B row n = (i, j, co) of item it is a 16-byte aligned row of the slot
//     of item it-i, read with ldmatrix. Item it's row goes into slot
//     it mod (k+3), built from a raw dy row the producers load one item
//     ahead; the k-1 rows before a block's first item (the same segment,
//     rows hh-k+1 .. hh-1) are built first, so the ring never holds a row
//     of another block's range. Rows outside [0, H) and N past k*k*Cout
//     read a zero row. Ragged K (pixels past the row) is zero in A.
//   - MMA warp w owns m16 tiles 2*(w%2), 2*(w%2)+1 and 2, 5 or 8 n8 tiles
//     (w/2 + 4t), <= 64 f32 accumulators a thread.
// Each block writes one partial (its channels and n8 tiles of one scratch
// row blockIdx.x): 132 rows at the tail. wgrad_reduce_kernel sums the rows
// in a fixed order (8 interleaved groups, then the 8 group sums in order):
// the item-to-block assignment depends only on the shapes and the SM
// count, so two launches give the same bits; there are no float atomics.
// What bounds it: the MMA warps. With two per SM sub-partition, each waits
// on its own ldmatrix -> mma chains and the tensor cores idle between
// them. wgmma is the next step, with N large enough to amortize each
// instruction: one wgmma per tap row (N = k*Cout rounded to 8) was slower.
//
// f32 route (wgrad_fma_kernel, and bf16 shapes whose ring does not fit
// shared memory): f32 FMA on the CUDA cores, as the tensor cores would need
// TF32 or a bf16 split, which change the f32 numbers. A block owns a
// strided set of T x T output tiles and a chunk of input channels, stages
// the x halo tile and the dy tile in shared memory as f32, and each thread
// keeps Cout accumulators for up to MaxPairs (tap, ci) pairs.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReduceGroups = 8;

// ---- bf16 tensor-core route ----
constexpr int kMC = 64;                 // input channels a block owns
constexpr int kNTZ = 32;                // n8 tiles a block owns, at most
constexpr int kSegMax = 160;            // pixels of an x row per item
constexpr int kStages = 4;              // items in flight
constexpr int kConsumers = 256;         // 8 MMA warps
constexpr int kProducers = 128;         // 4 warps staging x and dy
constexpr int kTcThreads = kConsumers + kProducers;
constexpr int kRawPerThread = 10;       // dy values a producer prefetches
constexpr size_t kTcSmemMax = 220 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// arrives on `bar` and adds `bytes` to the transfer it waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// TMA: box (64 channels, seg_w pixels, 1 row) at (c, w, row) into dst,
// completing on `bar`; out-of-range channels and pixels are zero
__device__ __forceinline__ void tma_load_x(void* dst, const CUtensorMap* map,
                                           int c, int w, int row,
                                           uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// barrier among the producer warps only
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
}

__device__ __forceinline__ int pos_mod(int a, int n) { return ((a % n) + n) % n; }

// NTW: n8 tiles an MMA warp owns (the plan picks 2, 5 or 8). MMA warp w
// owns m16 tiles 2*(w%2) and 2*(w%2)+1 and n8 tiles nz0 + w/2 + 4*t,
// t < NTW; tiles past the block's range read the zero row and are not
// written.
template <int NTW>
__global__ void __launch_bounds__(kTcThreads, 1)
wgrad_tc_kernel(const __grid_constant__ CUtensorMap x_map,  // x, if use_tma
                const __nv_bfloat16* __restrict__ x,    // (B, Hp, Wp, Cin)
                const __nv_bfloat16* __restrict__ dy,   // (B, H, W, Cout)
                float* __restrict__ partial,  // (gridDim.x, k*k*Cin*Cout)
                int B, int Hp, int Wp, int Cin, int Cout, int k, int seg_w,
                int nseg, int rs, int use_tma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the x stages sit on a 1024-byte boundary (TMA's 128-byte swizzle)
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int H = Hp - k + 1, W = Wp - k + 1;
  const int N = k * k * Cout;
  const int kc = k * Cout;                      // ring rows per dy row
  const int nslot = kStages + k - 1;            // dy rows in the ring
  const int raw_n = (seg_w + k - 1) * Cout;     // dy values of one row
  const int raw_pad = (raw_n + 7) & ~7;
  // kStages x (seg_w, kMC) x tiles, the ring (nslot, k*Cout, rs), a zero
  // row (rs), two raw dy rows (2, raw_pad) and full/empty barriers per stage
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint16_t* ring = reinterpret_cast<uint16_t*>(xs + kStages * seg_w * kMC);
  uint16_t* zrow = ring + (size_t)nslot * kc * rs;
  uint16_t* rawbuf = zrow + rs;
  uint64_t* full = reinterpret_cast<uint64_t*>(rawbuf + 2 * raw_pad);
  uint64_t* empty = full + kStages;
  const uint16_t* dyu = reinterpret_cast<const uint16_t*>(dy);

  const int c0 = blockIdx.y * kMC;
  const int cc = min(kMC, Cin - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // items are (segment s, row = b*Hp + hh), segment-major (the plan
  // keeps their count below 2^31); item it's dy row lives in ring slot
  // it mod nslot
  const int rows = B * Hp;
  const int items = rows * nseg;
  const int it0 = (int)((long long)blockIdx.x * items / gridDim.x);
  const int it1 = (int)((long long)(blockIdx.x + 1) * items / gridDim.x);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], kProducers + 1);   // one each, and the x copy
      mbar_init(&empty[st], kConsumers);
    }
  }
  for (int e = threadIdx.x; e < rs; e += kTcThreads) zrow[e] = 0;
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---------------- producers: x tiles and ring rows ----------------
    const int pt = threadIdx.x - kConsumers, pw = pt >> 5;

    // value e of dy row r of image b for the segment at w0: pixels
    // [w0-k+1, w0+seg_w) x Cout as they lie in NHWC, zero outside
    auto raw_value = [&](int b, int r, int w0, int e) -> uint16_t {
      const int g = (w0 - k + 1) * Cout + e;
      return (r >= 0 && r < H && g >= 0 && g < W * Cout)
                 ? dyu[((size_t)b * H + r) * W * Cout + g]
                 : (uint16_t)0;
    };
    // ring slot `slot` from raw row `rr`:
    // ring[slot][j][co][q] = raw[(q - j + k - 1) * Cout + co], two q a store
    auto fill_slot = [&](int slot, const uint16_t* rr) {
      uint32_t* d = reinterpret_cast<uint32_t*>(ring + (size_t)slot * kc * rs);
      constexpr int kWords = (kSegMax / 2 + 31) / 32;
      for (int ri = pw; ri < kc; ri += kProducers / 32) {
        const int j = ri / Cout, co = ri - j * Cout;
        const uint16_t* src = rr + (k - 1 - j) * Cout + co;
        uint32_t v[kWords];
#pragma unroll
        for (int u = 0; u < kWords; ++u) {
          const int qq = lane + 32 * u;
          v[u] = qq < (seg_w >> 1)
                     ? (uint32_t)src[2 * qq * Cout] |
                           ((uint32_t)src[(2 * qq + 1) * Cout] << 16)
                     : 0u;
        }
#pragma unroll
        for (int u = 0; u < kWords; ++u) {
          const int qq = lane + 32 * u;
          if (qq < (seg_w >> 1)) d[(ri * rs >> 1) + qq] = v[u];
        }
      }
    };
    // the raw dy row of item `it` (its row hh), into registers
    uint16_t pre[kRawPerThread];
    auto load_raw = [&](int it) {
      const int s = it / rows, row = it - s * rows;
      const int b = row / Hp, hh = row - b * Hp;
#pragma unroll
      for (int u = 0; u < kRawPerThread; ++u) {
        const int e = pt + u * kProducers;
        pre[u] = e < raw_n ? raw_value(b, hh, s * seg_w, e) : (uint16_t)0;
      }
    };

    if (it0 < it1) {
      // the rows before item it0 in its image: slots (it0 - i) mod nslot,
      // from raw rows staged in the last x stage (no copy uses it yet)
      const int s = it0 / rows, row = it0 - s * rows;
      const int b = row / Hp, hh = row - b * Hp;
      uint16_t* rr = reinterpret_cast<uint16_t*>(xs + (kStages - 1) * seg_w * kMC);
      for (int e0 = pt; e0 < k * raw_pad; e0 += 8 * kProducers) {
        uint16_t v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + u * kProducers, i = e / raw_pad;
          const int f = e - i * raw_pad;
          v[u] = (e < k * raw_pad && f < raw_n)
                     ? raw_value(b, hh - i, s * seg_w, f)
                     : (uint16_t)0;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (e0 + u * kProducers < k * raw_pad) rr[e0 + u * kProducers] = v[u];
      }
      load_raw(it0);
      producer_sync();
      for (int i = 1; i < k; ++i)
        if (hh - i >= 0 && hh - i < H)
          fill_slot(pos_mod(it0 - i, nslot), rr + i * raw_pad);
      producer_sync();   // the last stage's raw rows are read before it is reused
    }

    for (int it = it0; it < it1; ++it) {
      const int st = (it - it0) % kStages, round = (it - it0) / kStages;
      const int s = it / rows, row = it - s * rows;
      const int hh = row - (row / Hp) * Hp;
      const int w0 = s * seg_w, sw = min(seg_w, Wp - w0);
      // stage st and ring slot it mod nslot are free once the consumers
      // are done with item it - kStages
      mbar_wait(&empty[st], (round & 1) ^ 1);
      __nv_bfloat16* dst = xs + st * seg_w * kMC;
      if (use_tma) {
        if (pt == 0) {
          mbar_arrive_expect_tx(&full[st], seg_w * kMC * 2);
          tma_load_x(dst, &x_map, c0, w0, row, &full[st]);
        }
      } else {
        // Cin not a multiple of 8: plain copies, zero past the segment and
        // past Cin, in the layout TMA's 128-byte swizzle gives
        const __nv_bfloat16* src = x + ((size_t)row * Wp + w0) * Cin + c0;
        for (int e = pt; e < seg_w * kMC; e += kProducers) {
          const int p = e / kMC, c = e - p * kMC;
          dst[p * kMC + ((((c >> 3) ^ (p & 7)) << 3) | (c & 7))] =
              (p < sw && c < cc) ? src[(size_t)p * Cin + c]
                                 : __float2bfloat16(0.f);
        }
        if (pt == 0) mbar_arrive(&full[st]);
      }
      // this item's dy row, loaded one item ahead
      uint16_t* rr = rawbuf + (it & 1) * raw_pad;
#pragma unroll
      for (int u = 0; u < kRawPerThread; ++u) {
        const int e = pt + u * kProducers;
        if (e < raw_n) rr[e] = pre[u];
      }
      if (it + 1 < it1) load_raw(it + 1);
      producer_sync();
      if (hh < H) fill_slot(it % nslot, rr);
      mbar_arrive(&full[st]);
    }
    return;
  }

  // ---------------- consumers: the MMAs ----------------
  const int wm = warp & 1, wn = warp >> 1;
  const int nt_all = (N + 7) >> 3;
  const int nz0 = (int)((long long)blockIdx.z * nt_all / gridDim.z);
  const int nz1 = (int)((long long)(blockIdx.z + 1) * nt_all / gridDim.z);
  // this lane's B row of each owned n8 tile: (offset inside a ring slot)
  // * 64 + tap row i, or -1 past N or past the block's tiles (zero row)
  int b_row[NTW];
#pragma unroll
  for (int t = 0; t < NTW; ++t) {
    const int tile = nz0 + wn + 4 * t;
    const int n = tile * 8 + (lane & 7);
    b_row[t] = -1;
    if (tile < nz1 && n < N) {
      const int tap = n / Cout, co = n - tap * Cout;
      const int i = tap / k, j = tap - i * k;
      b_row[t] = (j * Cout + co) * rs * 64 + i;
    }
  }
  // this lane's ldmatrix.trans byte offset in an x stage, per owned m16
  // tile, at k-step 0 (a k-step adds 16 pixels: the swizzle is the same)
  uint32_t a_off[2];
  {
    const int p = (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int ch = 2 * (2 * wm + m) + ((lane >> 3) & 1);
      a_off[m] = (p * kMC + ((ch ^ (p & 7)) << 3)) * 2;
    }
  }
  float acc[2][NTW][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int t = 0; t < NTW; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][t][q] = 0.f;

  for (int it = it0; it < it1; ++it) {
    const int st = (it - it0) % kStages, round = (it - it0) / kStages;
    const int s = it / rows, row = it - s * rows;
    const int hh = row - (row / Hp) * Hp;
    const int sw = min(seg_w, Wp - s * seg_w);
    mbar_wait(&full[st], round & 1);
    const uint32_t xb = smem_u32(xs + st * seg_w * kMC);
    uint32_t b_addr[NTW];
#pragma unroll
    for (int t = 0; t < NTW; ++t) {
      const int i = b_row[t] & 63, r = hh - i;
      const uint16_t* rowp =
          (b_row[t] < 0 || r < 0 || r >= H)
              ? zrow
              : ring + (size_t)pos_mod(it - i, nslot) * kc * rs +
                    (b_row[t] >> 6);
      b_addr[t] = smem_u32(rowp) + ((lane >> 3) & 1) * 16;
    }
    const int ksteps = (sw + 15) >> 4;
#pragma unroll 2
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t a[2][4], bf[NTW][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        ldsm_x4_trans(a[m], xb + a_off[m] + ks * 16 * kMC * 2);
#pragma unroll
      for (int t = 0; t < NTW; ++t) ldsm_x2(bf[t], b_addr[t] + ks * 32);
#pragma unroll
      for (int t = 0; t < NTW; ++t)
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_bf16(acc[m][t], a[m], bf[t]);
    }
    mbar_arrive(&empty[st]);
  }

  // accumulator (m, t, q): ci = (2*wm+m)*16 + lane/4 (+8 for q >= 2),
  // n = tile*8 + 2*(lane%4) + q%2
  const size_t total = (size_t)k * k * Cin * Cout;
  float* out = partial + (size_t)blockIdx.x * total;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int t = 0; t < NTW; ++t) {
      const int tile = nz0 + wn + 4 * t;
      if (tile >= nz1) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ci = (2 * wm + m) * 16 + g + (q >> 1) * 8;
        const int n = tile * 8 + 2 * tig + (q & 1);
        if (ci < cc && n < N) {
          const int tap = n / Cout, co = n - tap * Cout;
          out[((size_t)tap * Cin + c0 + ci) * Cout + co] = acc[m][t][q];
        }
      }
    }
  }
}

// ---- f32-FMA route ----
constexpr size_t kFmaSmemBudget = 96 * 1024;   // per block, to keep 2 per SM

// (tap, ci) pairs one thread may own: Cout accumulators each, ~48 in all
template <int COUT>
struct MaxPairs {
  static constexpr int value = (48 / COUT) < 6 ? 6 : (48 / COUT);
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int COUT, typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_fma_kernel(const T* __restrict__ x,    // (B, Hp, Wp, Cin)
                 const T* __restrict__ dy,   // (B, H, W, COUT)
                 float* __restrict__ partial,  // (gridDim.x, k*k*Cin*COUT)
                 int B, int Hp, int Wp, int Cin, int k, int tile,
                 int cc_chunk) {
  constexpr int MAXP = MaxPairs<COUT>::value;
  extern __shared__ float fsmem[];
  const int H = Hp - k + 1, W = Wp - k + 1;
  const int halo = tile + k - 1;
  const int c0 = blockIdx.y * cc_chunk;
  const int cc = min(cc_chunk, Cin - c0);
  const int npairs = k * k * cc;
  const int qmax = (npairs + kThreads - 1) / kThreads;   // block-uniform
  float* xs = fsmem;                                     // (halo, halo, cc)
  float* ds = fsmem + (size_t)halo * halo * cc;          // (tile*tile, COUT)

  // smem offset of each owned pair relative to the pixel's corner; pairs
  // past npairs read a valid address and are never written out
  int off[MAXP];
  float acc[MAXP][COUT];
#pragma unroll
  for (int q = 0; q < MAXP; ++q) {
    const int p = threadIdx.x + q * kThreads;
    int o = 0;
    if (p < npairs) {
      const int tap = p / cc, ci = p - tap * cc;
      const int i = tap / k, j = tap - i * k;
      o = (i * halo + j) * cc + ci;
    }
    off[q] = o;
#pragma unroll
    for (int co = 0; co < COUT; ++co) acc[q][co] = 0.f;
  }

  const int tiles_h = (H + tile - 1) / tile, tiles_w = (W + tile - 1) / tile;
  const int per_image = tiles_h * tiles_w;
  const int n_tiles = B * per_image;
  const int nx = halo * halo * cc;
  const int nd = tile * tile * COUT;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / per_image;
    const int r_t = t - b * per_image;
    const int h0 = (r_t / tiles_w) * tile, w0 = (r_t % tiles_w) * tile;
    __syncthreads();   // the previous tile's reads are done
    const T* xb = x + (size_t)b * Hp * Wp * Cin;
    for (int e = threadIdx.x; e < nx; e += kThreads) {
      const int ci = e % cc, rc = e / cc;
      const int c = rc % halo, r = rc / halo;
      const int gh = h0 + r, gw = w0 + c;
      xs[e] = (gh < Hp && gw < Wp)
                  ? to_f32(xb[((size_t)gh * Wp + gw) * Cin + c0 + ci])
                  : 0.f;
    }
    const T* db = dy + (size_t)b * H * W * COUT;
    for (int e = threadIdx.x; e < nd; e += kThreads) {
      const int co = e % COUT, rc = e / COUT;
      const int c = rc % tile, r = rc / tile;
      const int gh = h0 + r, gw = w0 + c;
      ds[e] = (gh < H && gw < W)
                  ? to_f32(db[((size_t)gh * W + gw) * COUT + co])
                  : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < tile; ++r) {
      for (int c = 0; c < tile; ++c) {
        float d[COUT];
        const float* dp = ds + (r * tile + c) * COUT;
#pragma unroll
        for (int co = 0; co < COUT; ++co) d[co] = dp[co];
        const float* xp = xs + (size_t)(r * halo + c) * cc;
#pragma unroll
        for (int q = 0; q < MAXP; ++q) {
          if (q < qmax) {
            const float xv = xp[off[q]];
#pragma unroll
            for (int co = 0; co < COUT; ++co)
              acc[q][co] = fmaf(xv, d[co], acc[q][co]);
          }
        }
      }
    }
  }

  const size_t total = (size_t)k * k * Cin * COUT;
  float* out = partial + (size_t)blockIdx.x * total;
#pragma unroll
  for (int q = 0; q < MAXP; ++q) {
    const int p = threadIdx.x + q * kThreads;
    if (p < npairs) {
      const int tap = p / cc, ci = p - tap * cc;
      float* o = out + ((size_t)tap * Cin + c0 + ci) * COUT;
#pragma unroll
      for (int co = 0; co < COUT; ++co) o[co] = acc[q][co];
    }
  }
}

// out[e] = sum of the nparts scratch rows at e, in a fixed order: warp g
// of a block sums rows g, g+8, g+16, ... for 32 consecutive entries, then
// the 8 warp sums are added in order.
__global__ void __launch_bounds__(kThreads)
wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                    int nparts, size_t total) {
  __shared__ float sums[kReduceGroups][32];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const size_t e = (size_t)blockIdx.x * 32 + lane;
  float v = 0.f;
  if (e < total)
    for (int g = grp; g < nparts; g += kReduceGroups)
      v += partial[(size_t)g * total + e];
  sums[grp][lane] = v;
  __syncthreads();
  if (grp == 0 && e < total) {
    float s = sums[0][lane];
#pragma unroll
    for (int g = 1; g < kReduceGroups; ++g) s += sums[g][lane];
    out[e] = s;
  }
}

// ---- plans: the launch shapes from the problem's shapes and the SM count

struct TcPlan {
  int seg_w, nseg, rs, gx, gy, gz, ntw;
  size_t smem;
};

struct FmaPlan {
  int tile, cc_chunk, chunks, nparts;
  size_t smem;
};

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// false when the ring of k+1 dy rows does not fit even 16-pixel segments
bool make_tc_plan(int B, int Hp, int Wp, int Cin, int Cout, int k, int sms,
                  TcPlan* plan) {
  if (k > 63) return false;
  for (int cap = kSegMax; cap >= 16; cap /= 2) {
    const int nseg = (Wp + cap - 1) / cap;
    const int seg_w = ((Wp + nseg - 1) / nseg + 15) / 16 * 16;
    const int rs = seg_w + 8;   // rows 16 bytes apart mod 128: no conflicts
    const int raw_n = (seg_w + k - 1) * Cout;
    const int raw_pad = (raw_n + 7) & ~7;
    const size_t smem =
        1024 + 16 * kStages +
        sizeof(__nv_bfloat16) * (kStages * (size_t)seg_w * kMC +
                                 ((size_t)(kStages + k - 1) * k * Cout + 1) * rs +
                                 2 * (size_t)raw_pad);
    if (smem > kTcSmemMax || raw_n > kProducers * kRawPerThread ||
        (size_t)k * raw_pad > (size_t)seg_w * kMC ||
        (long long)B * Hp * nseg >= (1LL << 31))
      continue;
    plan->seg_w = seg_w;
    plan->nseg = nseg;
    plan->rs = rs;
    plan->smem = smem;
    plan->gy = (Cin + kMC - 1) / kMC;
    const int nt = (k * k * Cout + 7) / 8;
    plan->gz = (nt + kNTZ - 1) / kNTZ;
    const int per_warp = ((nt + plan->gz - 1) / plan->gz + 3) / 4;
    plan->ntw = per_warp <= 2 ? 2 : (per_warp <= 5 ? 5 : 8);
    long long gx = sms / (plan->gy * plan->gz);
    const long long items = (long long)B * Hp * nseg;
    if (gx > items) gx = items;
    plan->gx = (int)(gx < 1 ? 1 : gx);
    return true;
  }
  return false;
}

int max_pairs(int cout) {
  switch (cout) {
    case 1: return MaxPairs<1>::value;
    case 2: return MaxPairs<2>::value;
    case 3: return MaxPairs<3>::value;
    case 4: return MaxPairs<4>::value;
    case 5: return MaxPairs<5>::value;
    case 6: return MaxPairs<6>::value;
    case 7: return MaxPairs<7>::value;
    case 8: return MaxPairs<8>::value;
  }
  return 0;
}

cudaError_t make_fma_plan(int B, int Hp, int Wp, int Cin, int Cout, int k,
                          int sms, FmaPlan* plan) {
  const int cap = kThreads * max_pairs(Cout);
  plan->cc_chunk = cap / (k * k) < Cin ? cap / (k * k) : Cin;
  if (plan->cc_chunk <= 0) return cudaErrorInvalidValue;   // k too large
  plan->chunks = (Cin + plan->cc_chunk - 1) / plan->cc_chunk;
  const int H = Hp - k + 1, W = Wp - k + 1;
  plan->tile = 0;
  for (int t = 8; t >= 1; t /= 2) {
    const size_t halo = (size_t)(t + k - 1);
    const size_t smem =
        sizeof(float) * (halo * halo * plan->cc_chunk + (size_t)t * t * Cout);
    if (smem <= kFmaSmemBudget) {
      plan->tile = t;
      plan->smem = smem;
      break;
    }
  }
  if (plan->tile == 0) return cudaErrorInvalidValue;
  const long tiles = (long)B * ((H + plan->tile - 1) / plan->tile) *
                     ((W + plan->tile - 1) / plan->tile);
  long g = (2L * sms + plan->chunks - 1) / plan->chunks;
  if (g > tiles) g = tiles;
  plan->nparts = (int)(g < 1 ? 1 : g);
  return cudaSuccess;
}

struct Plan {
  bool tc;
  TcPlan t;
  FmaPlan f;
  int nparts;
};

cudaError_t make_plan(int in_bf16, int B, int Hp, int Wp, int Cin, int Cout,
                      int k, Plan* plan) {
  if (B <= 0 || Cin <= 0 || Cout < 1 || Cout > 8 || k <= 0 || Hp < k ||
      Wp < k)
    return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  plan->tc = in_bf16 && make_tc_plan(B, Hp, Wp, Cin, Cout, k, sms, &plan->t);
  if (plan->tc) {
    plan->nparts = plan->t.gx;
    return cudaSuccess;
  }
  const cudaError_t ef = make_fma_plan(B, Hp, Wp, Cin, Cout, k, sms, &plan->f);
  plan->nparts = plan->f.nparts;
  return ef;
}

// cuTensorMapEncodeTiled from the driver, found through the runtime
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

template <int NTW>
cudaError_t launch_tc_ntw(const void* x, const void* dy, float* partial,
                          int B, int Hp, int Wp, int Cin, int Cout, int k,
                          const TcPlan& p, cudaStream_t stream) {
  auto kernel = wgrad_tc_kernel<NTW>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return e;
  // x as (B*Hp rows, Wp pixels, Cin channels), boxes of (1, seg_w, 64);
  // TMA needs 16-byte row strides, so Cin % 8 == 0
  CUtensorMap map = {};
  const int use_tma = (Cin & 7) == 0;
  if (use_tma) {
    const auto encode = tensor_map_encoder();
    if (!encode) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)Cin, (cuuint64_t)Wp,
                                (cuuint64_t)B * Hp};
    const cuuint64_t strides[2] = {(cuuint64_t)Cin * 2,
                                   (cuuint64_t)Wp * Cin * 2};
    const cuuint32_t box[3] = {(cuuint32_t)kMC, (cuuint32_t)p.seg_w, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
               dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  const dim3 grid(p.gx, p.gy, p.gz);
  kernel<<<grid, kTcThreads, p.smem, stream>>>(
      map, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), partial, B, Hp, Wp, Cin, Cout, k,
      p.seg_w, p.nseg, p.rs, use_tma);
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* x, const void* dy, float* partial, int B,
                      int Hp, int Wp, int Cin, int Cout, int k,
                      const TcPlan& p, cudaStream_t s) {
  switch (p.ntw) {
    case 2: return launch_tc_ntw<2>(x, dy, partial, B, Hp, Wp, Cin, Cout, k, p, s);
    case 5: return launch_tc_ntw<5>(x, dy, partial, B, Hp, Wp, Cin, Cout, k, p, s);
    case 8: return launch_tc_ntw<8>(x, dy, partial, B, Hp, Wp, Cin, Cout, k, p, s);
  }
  return cudaErrorInvalidValue;
}

template <int COUT, typename T>
cudaError_t launch_fma(const void* x, const void* dy, float* partial, int B,
                       int Hp, int Wp, int Cin, int k, const FmaPlan& plan,
                       cudaStream_t stream) {
  auto kernel = wgrad_fma_kernel<COUT, T>;
  if (plan.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(plan.nparts, plan.chunks);
  kernel<<<grid, kThreads, plan.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), partial, B, Hp,
      Wp, Cin, k, plan.tile, plan.cc_chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_cout(int Cout, const void* x, const void* dy,
                          float* partial, int B, int Hp, int Wp, int Cin,
                          int k, const FmaPlan& plan, cudaStream_t s) {
  switch (Cout) {
    case 1: return launch_fma<1, T>(x, dy, partial, B, Hp, Wp, Cin, k, plan, s);
    case 2: return launch_fma<2, T>(x, dy, partial, B, Hp, Wp, Cin, k, plan, s);
    case 3: return launch_fma<3, T>(x, dy, partial, B, Hp, Wp, Cin, k, plan, s);
    case 4: return launch_fma<4, T>(x, dy, partial, B, Hp, Wp, Cin, k, plan, s);
    case 5: return launch_fma<5, T>(x, dy, partial, B, Hp, Wp, Cin, k, plan, s);
    case 6: return launch_fma<6, T>(x, dy, partial, B, Hp, Wp, Cin, k, plan, s);
    case 7: return launch_fma<7, T>(x, dy, partial, B, Hp, Wp, Cin, k, plan, s);
    case 8: return launch_fma<8, T>(x, dy, partial, B, Hp, Wp, Cin, k, plan, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes).
//
// pcgan_wgrad_nparts: the number of partial rows the scratch buffer of
// pcgan_wgrad must hold (nparts x k*k*Cin*Cout f32) for the route these
// shapes and input type take, or a negative CUDA error code when the
// shapes are not supported. *tc is set to 1 for the bf16 tensor-core
// route, 0 for the f32-FMA route.
extern "C" int pcgan_wgrad_nparts(int in_bf16, int B, int Hp, int Wp, int Cin,
                                  int Cout, int k, int* tc) {
  Plan plan;
  const cudaError_t e = make_plan(in_bf16, B, Hp, Wp, Cin, Cout, k, &plan);
  if (e != cudaSuccess) return -(int)e;
  *tc = plan.tc ? 1 : 0;
  return plan.nparts;
}

// pcgan_wgrad: launches the partial pass and the reduction on `stream` and
// returns cudaGetLastError() of the launches. in_bf16 selects bf16 inputs,
// else f32; nparts must be what pcgan_wgrad_nparts returned.
extern "C" int pcgan_wgrad(const void* x, const void* dy, void* scratch,
                           void* out, int in_bf16, int B, int Hp, int Wp,
                           int Cin, int Cout, int k, int nparts,
                           void* stream) {
  Plan plan;
  cudaError_t e = make_plan(in_bf16, B, Hp, Wp, Cin, Cout, k, &plan);
  if (e != cudaSuccess) return (int)e;
  if (plan.nparts != nparts) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(scratch);
  if (plan.tc)
    e = launch_tc(x, dy, partial, B, Hp, Wp, Cin, Cout, k, plan.t, s);
  else if (in_bf16)
    e = dispatch_cout<__nv_bfloat16>(Cout, x, dy, partial, B, Hp, Wp, Cin, k,
                                     plan.f, s);
  else
    e = dispatch_cout<float>(Cout, x, dy, partial, B, Hp, Wp, Cin, k, plan.f,
                             s);
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)k * k * Cin * Cout;
  const unsigned blocks = (unsigned)((total + 31) / 32);
  wgrad_reduce_kernel<<<blocks, kThreads, 0, s>>>(
      partial, static_cast<float*>(out), plan.nparts, total);
  return (int)cudaGetLastError();
}
