// Fused input preprocessing for Hopper (sm_90a): resize + crop + flip +
// normalize of a u8 NHWC batch in one kernel.
//
// Replaces: pcgan_tpu/ops/pallas_preprocess.py, pallas_preprocess_batch
// (kernel body _kernel). For each image b and channel c it computes
//
//   out[b,:,:,c] = clip(Mh[y0:y0+crop] . img[b,:,:,c] . Mw[sel]^T * 2/255 - 1,
//                       -1, 1),   sel(q) = x0 + (flip ? crop-1-q : q)
//
// Mh (load, H) and Mw (load, W) are the PIL-faithful resize matrices
// (ops/resize.py resize_matrix). The kernel reads them as bands
// (ops/resize.py resize_band): row y of M is zero outside
// [lo[y], lo[y]+K), and taps[y, t] = M[y, lo[y]+t]. Everything runs in
// full f32 FMA on the CUDA cores, never TF32: u8 data needs more than 8
// mantissa bits through the two products. Each sum runs over ascending
// input index, and the terms a dense product adds outside the band are
// exact zeros (fmaf(0, v, acc) == acc), so the result has the bits of the
// dense products. Normalization comes after both products, as in the TPU
// kernel.
//
// Bound: bytes. At B 8, 200 -> 143 -> 128, C 3 the function needs
// ~10.7 MFLOP (at most 6 non-zero bicubic taps a row, the vertical pass
// over only the ~183 needed columns) on ~1.6 MB (the ~183 x 183 input
// pixels each crop's supports touch, u8; the bf16 output): ~0.00048 ms at
// 3.35 TB/s, below the cost of one launch. So the kernel is bound by
// latency: the design does only the band's arithmetic and gives each block
// one short chain of dependent loads, with enough blocks to keep every SM
// busy.
//
// Bands. Under a spatial mesh axis each rank computes on a band of rows of
// every image: the kernel then writes only rows [r0, r0 + rows) of each
// crop, grid (rows, B), output (B, rows, crop, C). The crop offset clamps
// first, and the band starts r0 rows into the crop after that. The whole
// crop is the band r0 = 0, rows = crop.
//
// Design. The TPU kernel builds 0/1 selector matrices for crop and flip
// (Mosaic has no unaligned sublane slice and no `rev`) and transposes the
// image to NCHW; here the block indexes the band rows directly and reads
// NHWC u8 as it lies. One block owns (image b, output row y): B x crop
// blocks, 1024 at the main shape.
//   1. vertical pass: V[w*C+c] = sum_t taps_h[y, t] * img[b, lo_h[y]+t, w,
//      c] over only the input columns the crop's columns touch
//      (lo_w[x0] .. lo_w[x0+crop-1]+K_w), one thread per (w, c), reads
//      coalesced along NHWC; V stays in shared memory;
//   2. horizontal pass: out[y, q, c] = sum_t taps_w[sel(q), t] *
//      V[(lo_w[sel(q)]+t)*C+c], one thread per (q, c), writes coalesced
//      along NHWC.
// The block loads its crop offsets and flip bit itself. Crop offsets clamp
// to [0, load - crop] as jax.lax.dynamic_slice clamps them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
preprocess_kernel(const uint8_t* __restrict__ img,   // (B, H, W, C)
                  const int* __restrict__ lo_h,      // (load,)
                  const float* __restrict__ taps_h,  // (load, kh)
                  const int* __restrict__ lo_w,      // (load,)
                  const float* __restrict__ taps_w,  // (load, kw)
                  const int* __restrict__ cy, const int* __restrict__ cx,
                  const int* __restrict__ flip,      // (B,) each
                  OutT* __restrict__ out,            // (B, rows, crop, C)
                  int H, int W, int C, int load, int crop, int kh, int kw,
                  int r0, int rows) {
  extern __shared__ float v_s[];   // ((whi - wlo) * C,): the vertical pass

  const int b = blockIdx.y, row = blockIdx.x;
  const int span = load - crop;
  const int y = min(max(cy[b], 0), span) + r0 + row;
  const int x0 = min(max(cx[b], 0), span);
  const bool flipped = flip[b] != 0;
  const int WC = W * C;
  // input columns the crop's columns read (band starts are non-decreasing)
  const int wlo = lo_w[x0];
  const int nj = (lo_w[x0 + crop - 1] + kw - wlo) * C;

  const float* th = taps_h + (size_t)y * kh;
  const uint8_t* src = img + ((size_t)b * H + lo_h[y]) * WC + (size_t)wlo * C;
  for (int j = threadIdx.x; j < nj; j += kThreads) {
    float acc = 0.f;
#pragma unroll 8
    for (int u = 0; u < kh; ++u)
      acc = fmaf(__ldg(th + u), (float)src[(size_t)u * WC + j], acc);
    v_s[j] = acc;
  }
  __syncthreads();

  OutT* o = out + ((size_t)b * rows + row) * crop * C;
  for (int e = threadIdx.x; e < crop * C; e += kThreads) {
    const int q = e / C, c = e - q * C;
    const int sel = x0 + (flipped ? crop - 1 - q : q);
    const float* tw = taps_w + (size_t)sel * kw;
    const float* v = v_s + (lo_w[sel] - wlo) * C + c;
    float acc = 0.f;
#pragma unroll 8
    for (int u = 0; u < kw; ++u) acc = fmaf(v[u * C], __ldg(tw + u), acc);
    store_out(o + e, fminf(fmaxf(acc * (2.0f / 255.0f) - 1.0f, -1.0f), 1.0f));
  }
}

template <typename OutT>
cudaError_t launch(const void* img, const void* lo_h, const void* taps_h,
                   const void* lo_w, const void* taps_w, const void* cy,
                   const void* cx, const void* flip, void* out, int B, int H,
                   int W, int C, int load, int crop, int kh, int kw, int r0,
                   int rows, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)W * C;
  auto kernel = preprocess_kernel<OutT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(rows, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(img), static_cast<const int*>(lo_h),
      static_cast<const float*>(taps_h), static_cast<const int*>(lo_w),
      static_cast<const float*>(taps_w), static_cast<const int*>(cy),
      static_cast<const int*>(cx), static_cast<const int*>(flip),
      static_cast<OutT*>(out), H, W, C, load, crop, kh, kw, r0, rows);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes): launches on `stream` and returns
// cudaGetLastError() of the launch. out_bf16 selects a bf16 output, else
// f32. lo_h/taps_h and lo_w/taps_w are resize_band(H, load) and
// resize_band(W, load), of kh and kw taps. Rows [r0, r0 + rows) of each
// crop are written (r0 0, rows crop: the whole crop).
extern "C" int pcgan_preprocess(const void* img, const void* lo_h,
                                const void* taps_h, const void* lo_w,
                                const void* taps_w, const void* cy,
                                const void* cx, const void* flip, void* out,
                                int out_bf16, int B, int H, int W, int C,
                                int load, int crop, int kh, int kw, int r0,
                                int rows, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || crop <= 0 || crop > load ||
      kh <= 0 || kh > H || kw <= 0 || kw > W || r0 < 0 || rows <= 0 ||
      r0 + rows > crop)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      out_bf16
          ? launch<__nv_bfloat16>(img, lo_h, taps_h, lo_w, taps_w, cy, cx,
                                  flip, out, B, H, W, C, load, crop, kh, kw,
                                  r0, rows, s)
          : launch<float>(img, lo_h, taps_h, lo_w, taps_w, cy, cx, flip, out,
                          B, H, W, C, load, crop, kh, kw, r0, rows, s);
  return (int)e;
}
