// Instance norm of bf16 NCHW with its activation and residual, forward and
// backward, for Hopper (sm_90a): one pass over each (n, c) plane.
//
// Replaces no TPU kernel: the JAX package leaves instance norm to XLA,
// which fuses it with its epilogue. In eager PyTorch the same function
// (pcgan_tpu_torch/models/layers.py instance_norm, bf16 form) is about a
// dozen elementwise and reduction launches forward and as many backward,
// each writing a full-size tensor, several of them f32. These two kernels
// compute, for x (N, C, H, W) bf16 contiguous,
//
//   forward   y   = bf16((x - mean) * rstd)          (the norm, rounded once)
//             out = act(y) [+ residual]               (rounded again after +)
//   with      mean = sum(x) / HW,  mean2 = sum(bf16(x * x)) / HW   (f32)
//             var  = max(mean2 - mean^2, 0),  rstd = rsqrt(var + eps)
//   backward  g'  = g * act'(y)        (leaky: bf16(g * 0.2) where y <= 0)
//             dx  = rstd * (g' - mean(g') - xhat * mean(g' * xhat) * keep)
//   with      xhat = (x - mean) * rstd,  keep = (mean2 - mean^2 >= 0)
//
// act is none, relu or leaky_relu(0.2); the residual's gradient is g
// itself, so the backward has no residual term. keep follows torch's
// clamp, whose gradient passes where its input is >= 0: where the clamp
// cut a negative variance to 0 the variance term is dropped. The forward
// writes (mean, rstd, keep) per plane as three f32 rows of (3, N*C); the
// backward reads them and recomputes xhat, y and the activation's mask
// from x, so the autograd Function keeps only x and those rows.
//
// Bound: bytes. Forward: read x (2 B an element), write out (2 B), read
// the residual (2 B) where there is one; backward: read x and g, write dx
// (6 B). The arithmetic is ~10 flops an element, far below the ~295
// flops a byte at which the tensor cores would bound. At G's 256 px stem
// (64 x 64 planes of 256 x 256, 268 M elements) that is 1.07 GB forward,
// 0.32 ms at 3.35 TB/s, and 1.61 GB backward, 0.48 ms.
//
// Design. A group of threads owns a plane and reads it once: with 16-byte
// loads (8 bf16) where the plane's length is a multiple of 8 and the
// pointers are 16-byte aligned, else with 2-byte loads. On the way it
// keeps the plane in shared memory and sums the moments in f32 registers;
// a warp-shuffle tree and one pass over the group's warp partials, in a
// fixed order, give every thread the totals (deterministic: the same bits
// every run). The second pass reads the plane back from shared memory and
// writes the result once. The group's size follows the plane: about 32
// elements a thread, a power of two from one warp to 1,024 threads, and
// a block takes 256 / group planes where a group is smaller than 256
// threads. G's 256 px planes (256 x 256, 128 KB of bf16) take one block's
// shared memory. The backward keeps both x and g in shared memory where
// the two fit (planes up to ~58,000 elements) and else keeps x and reads g
// a second time, from L2 (the block read it moments before); a plane
// larger than shared memory (above ~116,000 elements, 341 x 341) is read
// a second time from device memory. Everything launches on the caller's
// stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum Act { kNone = 0, kRelu = 1, kLeaky = 2 };

constexpr float kSlope = 0.2f;          // leaky_relu's negative slope
constexpr int kBlock = 256;             // threads of a block of small groups
constexpr int kMaxWarps = 32;
// a block's dynamic shared memory on H100: 227 KB less group_sum2's 256 B
constexpr size_t kSmemMax = 227 * 1024 - 256;

__device__ __forceinline__ float act_fwd(float y, int act) {
  // y is the bf16 norm output as f32; the result is rounded by the caller
  if (act == kRelu) return y > 0.f ? y : 0.f;
  if (act == kLeaky) return y > 0.f ? y : y * kSlope;
  return y;
}

__device__ __forceinline__ float act_bwd(float g, float y, int act) {
  // torch's backward in bf16: relu's passes g where its output is > 0,
  // leaky's rounds g * 0.2 to bf16 where its input is <= 0
  if (act == kRelu) return y > 0.f ? g : 0.f;
  if (act == kLeaky)
    return y > 0.f ? g : __bfloat162float(__float2bfloat16_rn(g * kSlope));
  return g;
}

__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Both sums over the calling thread's group of `group` threads (a whole
// number of warps, aligned to them): a shuffle tree in each warp, then
// every thread adds its group's warp partials in warp order. Every thread
// of the block must call it.
__device__ __forceinline__ void group_sum2(float& a, float& b, int group) {
  __shared__ float part[2][kMaxWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[0][warp] = a;
    part[1][warp] = b;
  }
  __syncthreads();
  const int warps = group >> 5, first = (threadIdx.x / group) * warps;
  a = 0.f;
  b = 0.f;
  for (int w = 0; w < warps; ++w) {
    a += part[0][first + w];
    b += part[1][first + w];
  }
}

template <bool VEC>
__global__ void __launch_bounds__(1024)
norm_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                bf16* __restrict__ out, float* __restrict__ stats, int nc,
                int hw, int group, int act, float eps, int cache_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = (hw + 7) & ~7;
  const int g = threadIdx.x / group, t = threadIdx.x % group;
  const long plane = (long)blockIdx.x * (blockDim.x / group) + g;
  const bool live = plane < nc;
  bf16* cache = reinterpret_cast<bf16*>(smem) + (size_t)g * stride;
  const size_t base = (size_t)plane * hw;

  float s1 = 0.f, s2 = 0.f;
  if (live) {
    if (VEC) {
      const uint4* src = reinterpret_cast<const uint4*>(x + base);
      uint4* dst = reinterpret_cast<uint4*>(cache);
#pragma unroll 4
      for (int v = t; v < hw / 8; v += group) {
        const uint4 u = src[v];
        if (cache_x) dst[v] = u;
        const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float f = __bfloat162float(e[k]);
          s1 += f;
          s2 += rnd(f * f);
        }
      }
    } else {
      for (int i = t; i < hw; i += group) {
        const bf16 e = x[base + i];
        if (cache_x) cache[i] = e;
        const float f = __bfloat162float(e);
        s1 += f;
        s2 += rnd(f * f);
      }
    }
  }
  group_sum2(s1, s2, group);
  const float mean = s1 / hw;
  const float var = s2 / hw - mean * mean;
  const float rstd = rsqrtf(fmaxf(var, 0.f) + eps);
  if (!live) return;
  if (t == 0) {
    stats[plane] = mean;
    stats[nc + plane] = rstd;
    stats[2L * nc + plane] = var >= 0.f ? 1.f : 0.f;
  }
  const bf16* xsrc = cache_x ? cache : x + base;
  if (VEC) {
    const uint4* src = reinterpret_cast<const uint4*>(xsrc);
    const uint4* rsrc = reinterpret_cast<const uint4*>(res + base);
    uint4* dst = reinterpret_cast<uint4*>(out + base);
#pragma unroll 4
    for (int v = t; v < hw / 8; v += group) {
      const uint4 u = src[v];
      uint4 r, o;
      if (res != nullptr) r = rsrc[v];
      const bf16* e = reinterpret_cast<const bf16*>(&u);
      const bf16* re = reinterpret_cast<const bf16*>(&r);
      bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float y = rnd((__bfloat162float(e[k]) - mean) * rstd);
        float a = rnd(act_fwd(y, act));
        if (res != nullptr) a += __bfloat162float(re[k]);
        oe[k] = __float2bfloat16_rn(a);
      }
      dst[v] = o;
    }
  } else {
    for (int i = t; i < hw; i += group) {
      const float y = rnd((__bfloat162float(xsrc[i]) - mean) * rstd);
      float a = rnd(act_fwd(y, act));
      if (res != nullptr) a += __bfloat162float(res[base + i]);
      out[base + i] = __float2bfloat16_rn(a);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(1024)
norm_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                const float* __restrict__ stats, bf16* __restrict__ dx,
                int nc, int hw, int group, int act, int cache_x,
                int cache_g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = (hw + 7) & ~7;
  const int planes = blockDim.x / group;
  const int g = threadIdx.x / group, t = threadIdx.x % group;
  const long plane = (long)blockIdx.x * planes + g;
  const bool live = plane < nc;
  bf16* xc = reinterpret_cast<bf16*>(smem) + (size_t)g * stride;
  bf16* gc = reinterpret_cast<bf16*>(smem) + (size_t)(planes + g) * stride;
  const size_t base = (size_t)plane * hw;
  float mean = 0.f, rstd = 0.f, keep = 0.f;
  if (live) {
    mean = stats[plane];
    rstd = stats[nc + plane];
    keep = stats[2L * nc + plane];
  }

  float s1 = 0.f, s2 = 0.f;            // sum g', sum g' * xhat
  if (live) {
    if (VEC) {
      const uint4* xs = reinterpret_cast<const uint4*>(x + base);
      const uint4* gs = reinterpret_cast<const uint4*>(gy + base);
#pragma unroll 4
      for (int v = t; v < hw / 8; v += group) {
        const uint4 xu = xs[v], gu = gs[v];
        if (cache_x) reinterpret_cast<uint4*>(xc)[v] = xu;
        if (cache_g) reinterpret_cast<uint4*>(gc)[v] = gu;
        const bf16* xe = reinterpret_cast<const bf16*>(&xu);
        const bf16* ge = reinterpret_cast<const bf16*>(&gu);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xh = (__bfloat162float(xe[k]) - mean) * rstd;
          const float gp = act_bwd(__bfloat162float(ge[k]), rnd(xh), act);
          s1 += gp;
          s2 += gp * xh;
        }
      }
    } else {
      for (int i = t; i < hw; i += group) {
        const bf16 xe = x[base + i], ge = gy[base + i];
        if (cache_x) xc[i] = xe;
        if (cache_g) gc[i] = ge;
        const float xh = (__bfloat162float(xe) - mean) * rstd;
        const float gp = act_bwd(__bfloat162float(ge), rnd(xh), act);
        s1 += gp;
        s2 += gp * xh;
      }
    }
  }
  group_sum2(s1, s2, group);
  if (!live) return;
  const float mg = s1 / hw, mgx = keep * (s2 / hw);
  const bf16* xsrc = cache_x ? xc : x + base;
  const bf16* gsrc = cache_g ? gc : gy + base;
  if (VEC) {
    const uint4* xs = reinterpret_cast<const uint4*>(xsrc);
    const uint4* gs = reinterpret_cast<const uint4*>(gsrc);
    uint4* dst = reinterpret_cast<uint4*>(dx + base);
#pragma unroll 4
    for (int v = t; v < hw / 8; v += group) {
      const uint4 xu = xs[v], gu = gs[v];
      uint4 o;
      const bf16* xe = reinterpret_cast<const bf16*>(&xu);
      const bf16* ge = reinterpret_cast<const bf16*>(&gu);
      bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float xh = (__bfloat162float(xe[k]) - mean) * rstd;
        const float gp = act_bwd(__bfloat162float(ge[k]), rnd(xh), act);
        oe[k] = __float2bfloat16_rn(rstd * (gp - mg - xh * mgx));
      }
      dst[v] = o;
    }
  } else {
    for (int i = t; i < hw; i += group) {
      const float xh = (__bfloat162float(xsrc[i]) - mean) * rstd;
      const float gp = act_bwd(__bfloat162float(gsrc[i]), rnd(xh), act);
      dx[base + i] = __float2bfloat16_rn(rstd * (gp - mg - xh * mgx));
    }
  }
}

// Threads a plane (a power of two, 32..1024, ~32 elements a thread) and
// planes a block.
void plan(int hw, int* group, int* planes) {
  int g = 32;
  while (g < 1024 && g * 32 < hw) g <<= 1;
  *group = g;
  *planes = g < kBlock ? kBlock / g : 1;
}

bool aligned(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Above 48 KB of dynamic shared memory a kernel must opt in; each of the
// four kernels (`which`) does so once, for the most it may use, so that no
// attribute is set while a CUDA graph captures the launches.
template <typename K>
cudaError_t allow_smem(K kernel, int which, size_t bytes) {
  static bool done[4] = {false, false, false, false};
  if (bytes <= 48 * 1024 || done[which]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
  done[which] = err == cudaSuccess;
  return err;
}

}  // namespace

extern "C" {

// out = act(IN(x)) [+ res] and stats (3, nc) f32; res may be null. Returns
// a cudaError_t (0: launched).
int pcgan_instance_norm_fwd(const void* x, const void* res, void* out,
                            void* stats, int nc, int hw, int act, float eps,
                            void* stream) {
  if (nc <= 0 || hw <= 0) return 0;
  int group, planes;
  plan(hw, &group, &planes);
  const size_t one = (size_t)planes * ((hw + 7) & ~7) * sizeof(bf16);
  const int cache_x = one <= kSmemMax;
  const size_t smem = cache_x ? one : 0;
  const bool vec = hw % 8 == 0 && aligned(x) && aligned(res) &&
                   aligned(out);
  const dim3 grid((nc + planes - 1) / planes), block(group * planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* rb = static_cast<const bf16*>(res);
  bf16* ob = static_cast<bf16*>(out);
  float* st = static_cast<float*>(stats);
  cudaError_t err;
  if (vec) {
    err = allow_smem(norm_fwd_kernel<true>, 0, smem);
    if (err == cudaSuccess)
      norm_fwd_kernel<true><<<grid, block, smem, s>>>(xb, rb, ob, st, nc, hw,
                                                       group, act, eps,
                                                       cache_x);
  } else {
    err = allow_smem(norm_fwd_kernel<false>, 1, smem);
    if (err == cudaSuccess)
      norm_fwd_kernel<false><<<grid, block, smem, s>>>(xb, rb, ob, st, nc,
                                                        hw, group, act, eps,
                                                        cache_x);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// dx of pcgan_instance_norm_fwd's out with respect to x, from the forward's
// x and stats and out's gradient gy. Returns a cudaError_t (0: launched).
int pcgan_instance_norm_bwd(const void* x, const void* gy, const void* stats,
                            void* dx, int nc, int hw, int act,
                            void* stream) {
  if (nc <= 0 || hw <= 0) return 0;
  int group, planes;
  plan(hw, &group, &planes);
  const size_t one = (size_t)planes * ((hw + 7) & ~7) * sizeof(bf16);
  const int cache_x = one <= kSmemMax;
  const int cache_g = 2 * one <= kSmemMax;
  const size_t smem = (cache_x + cache_g) * one;
  const bool vec = hw % 8 == 0 && aligned(x) && aligned(gy) && aligned(dx);
  const dim3 grid((nc + planes - 1) / planes), block(group * planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(gy);
  const float* st = static_cast<const float*>(stats);
  bf16* db = static_cast<bf16*>(dx);
  cudaError_t err;
  if (vec) {
    err = allow_smem(norm_bwd_kernel<true>, 2, smem);
    if (err == cudaSuccess)
      norm_bwd_kernel<true><<<grid, block, smem, s>>>(xb, gb, st, db, nc, hw,
                                                       group, act, cache_x,
                                                       cache_g);
  } else {
    err = allow_smem(norm_bwd_kernel<false>, 3, smem);
    if (err == cudaSuccess)
      norm_bwd_kernel<false><<<grid, block, smem, s>>>(xb, gb, st, db, nc,
                                                        hw, group, act,
                                                        cache_x, cache_g);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
