// Weight gradient of a stride-1 VALID conv with a tiny C_out, for Hopper
// (sm_90a):
//
//   dW[i,j,ci,co] = sum_{b,h,w} x_pad[b,h+i,w+j,ci] * dy[b,h,w,co]
//
// x_pad (B, Hp, Wp, Cin) and dy (B, Hp-k+1, Wp-k+1, Cout) are NHWC and
// contiguous, both bf16 or both f32; products and sums are f32 and the
// output is (k, k, Cin, Cout) f32. 1 <= Cout <= 8, any k with k*k <=
// kThreads * MaxPairs<Cout>, any Hp, Wp >= k.
//
// Replaces: pcgan_tpu/ops/pallas_wgrad.py, conv_wgrad_lowcout (kernel body
// _wgrad_kernel). The TPU kernel zero-embeds and pre-transposes the
// cotangent, keeps rows as a batch dimension of its MXU products and
// accumulates into one output block over a sequential grid: all Mosaic
// workarounds, none carried over here.
//
// Bound: bytes. At the G tail of the default step (x_pad (16, 134, 134, 64)
// bf16, dy (16, 128, 128, 3), k 7) the function moves ~38.4 MB and does
// 4.93 GFLOP: ~0.0115 ms at 3.35 TB/s against 0.074 ms at the 67 TFLOP/s
// f32 FMA peak of the CUDA cores, so this f32-FMA kernel is limited by its
// arithmetic and its shared-memory loads (one load per Cout FMAs), not by
// the bytes. Tensor cores (wgmma), TMA and a one-pass reduction are later
// work.
//
// Design.
//   pass 1 (wgrad_partial_kernel): a block owns a fixed, strided set of
//     output tiles (image b, T x T output pixels) and one chunk of input
//     channels [c0, c0+cc). Per tile it stages the x halo tile
//     ((T+k-1) x (T+k-1) x cc) and the dy tile (T x T x Cout) in shared
//     memory as f32; pixels outside the output are zero in dy, so they add
//     nothing. Each thread owns up to MaxPairs (tap, ci) pairs, consecutive
//     ci across a warp (conflict-free loads), with Cout accumulators each in
//     registers; per pixel it loads the Cout dy values once (a broadcast)
//     and does one x load per pair. At the end the block writes its partial
//     sums (every (tap, ci, co) of its chunk exactly once) to row blockIdx.x
//     of a scratch buffer.
//   pass 2 (wgrad_reduce_kernel): out[e] = sum over the scratch rows in
//     fixed order. The tile-to-block assignment depends only on the shapes
//     and the SM count, so the result is the same from run to run; there
//     are no float atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 256;
constexpr size_t kSmemBudget = 96 * 1024;   // per block, to keep 2 per SM

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
wgrad_partial_kernel(const T* __restrict__ x,    // (B, Hp, Wp, Cin)
                     const T* __restrict__ dy,   // (B, H, W, COUT)
                     float* __restrict__ partial,  // (gridDim.x, k*k*Cin*COUT)
                     int B, int Hp, int Wp, int Cin, int k, int tile,
                     int cc_chunk) {
  constexpr int MAXP = MaxPairs<COUT>::value;
  extern __shared__ float smem[];
  const int H = Hp - k + 1, W = Wp - k + 1;
  const int halo = tile + k - 1;
  const int c0 = blockIdx.y * cc_chunk;
  const int cc = min(cc_chunk, Cin - c0);
  const int npairs = k * k * cc;
  const int qmax = (npairs + kThreads - 1) / kThreads;   // block-uniform
  float* xs = smem;                                     // (halo, halo, cc)
  float* ds = smem + (size_t)halo * halo * cc;          // (tile*tile, COUT)

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

__global__ void wgrad_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int nparts,
                                    size_t total) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = 0.f;
  for (int g = 0; g < nparts; ++g) s += partial[(size_t)g * total + e];
  out[e] = s;
}

struct Plan {
  int tile, cc_chunk, chunks, nparts;
  size_t smem;
};

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

// The launch shape from the problem's shapes and the SM count alone.
cudaError_t make_plan(int B, int Hp, int Wp, int Cin, int Cout, int k,
                      Plan* plan) {
  if (B <= 0 || Cin <= 0 || Cout < 1 || Cout > 8 || k <= 0 || Hp < k ||
      Wp < k)
    return cudaErrorInvalidValue;
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
    if (smem <= kSmemBudget) {
      plan->tile = t;
      plan->smem = smem;
      break;
    }
  }
  if (plan->tile == 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long tiles = (long)B * ((H + plan->tile - 1) / plan->tile) *
                     ((W + plan->tile - 1) / plan->tile);
  long g = (2L * sms + plan->chunks - 1) / plan->chunks;
  if (g > tiles) g = tiles;
  plan->nparts = (int)(g < 1 ? 1 : g);
  return cudaSuccess;
}

template <int COUT, typename T>
cudaError_t launch_partial(const void* x, const void* dy, float* partial,
                           int B, int Hp, int Wp, int Cin, int k,
                           const Plan& plan, cudaStream_t stream) {
  auto kernel = wgrad_partial_kernel<COUT, T>;
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
                          int k, const Plan& plan, cudaStream_t s) {
  switch (Cout) {
    case 1: return launch_partial<1, T>(x, dy, partial, B, Hp, Wp, Cin, k, plan, s);
    case 2: return launch_partial<2, T>(x, dy, partial, B, Hp, Wp, Cin, k, plan, s);
    case 3: return launch_partial<3, T>(x, dy, partial, B, Hp, Wp, Cin, k, plan, s);
    case 4: return launch_partial<4, T>(x, dy, partial, B, Hp, Wp, Cin, k, plan, s);
    case 5: return launch_partial<5, T>(x, dy, partial, B, Hp, Wp, Cin, k, plan, s);
    case 6: return launch_partial<6, T>(x, dy, partial, B, Hp, Wp, Cin, k, plan, s);
    case 7: return launch_partial<7, T>(x, dy, partial, B, Hp, Wp, Cin, k, plan, s);
    case 8: return launch_partial<8, T>(x, dy, partial, B, Hp, Wp, Cin, k, plan, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes).
//
// pcgan_wgrad_nparts: the number of partial rows the scratch buffer of
// pcgan_wgrad must hold (nparts x k*k*Cin*Cout f32), or a negative CUDA
// error code when the shapes are not supported.
extern "C" int pcgan_wgrad_nparts(int B, int Hp, int Wp, int Cin, int Cout,
                                  int k) {
  Plan plan;
  const cudaError_t e = make_plan(B, Hp, Wp, Cin, Cout, k, &plan);
  return e == cudaSuccess ? plan.nparts : -(int)e;
}

// pcgan_wgrad: launches both passes on `stream` and returns
// cudaGetLastError() of the launches. in_bf16 selects bf16 inputs, else
// f32; nparts must be what pcgan_wgrad_nparts returned for these shapes.
extern "C" int pcgan_wgrad(const void* x, const void* dy, void* scratch,
                           void* out, int in_bf16, int B, int Hp, int Wp,
                           int Cin, int Cout, int k, int nparts,
                           void* stream) {
  Plan plan;
  cudaError_t e = make_plan(B, Hp, Wp, Cin, Cout, k, &plan);
  if (e != cudaSuccess) return (int)e;
  if (plan.nparts != nparts) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(scratch);
  e = in_bf16 ? dispatch_cout<__nv_bfloat16>(Cout, x, dy, partial, B, Hp, Wp,
                                             Cin, k, plan, s)
              : dispatch_cout<float>(Cout, x, dy, partial, B, Hp, Wp, Cin, k,
                                     plan, s);
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)k * k * Cin * Cout;
  const unsigned blocks =
      (unsigned)((total + kReduceThreads - 1) / kReduceThreads);
  wgrad_reduce_kernel<<<blocks, kReduceThreads, 0, s>>>(
      partial, static_cast<float*>(out), plan.nparts, total);
  return (int)cudaGetLastError();
}
