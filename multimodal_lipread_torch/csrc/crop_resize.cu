// Lip crop for Hopper (sm_90a): box crop + aspect-preserving bilinear resize
// + average-colour pad (+ optional /255), one launch for any number of frames.
//
// Replaces multimodal_lipread_tpu/ops/crop_resize.py::crop_resize_pad and
// crop_resize_pad_normalize (an XLA gather program on the TPU, no Pallas).
// Same function, per frame (H, W, C) uint8 and box (x_min, y_min, x_max,
// y_max) int32:
//   letterbox size in integers: wide <=> cw*th > ch*tw, then (tw, tw*ch/cw)
//   or (th*cw/ch, th), centred on the (th, tw) canvas;
//   per output pixel inside it, cv2 INTER_LINEAR's source coordinate
//   (dst + 0.5) * scale - 0.5 clamped to the crop and the frame, the
//   bilinear blend of its 4 neighbours in float32, rounded half to even and
//   clipped to [0, 255];
//   pad colour per channel = floor(sum of the rounded in-region values /
//   their count); a degenerate box gives a blank frame.
// Plain version: multimodal_lipread_torch/ops/crop_resize.py
// ::crop_resize_pad_reference. The kernel is held to it bit for bit, so the
// float arithmetic is written out with round-to-nearest intrinsics: no FMA
// contraction of the coordinate map or of the blend (__fmul_rn/__fadd_rn),
// rintf (half to even; roundf rounds half away from zero), an IEEE division,
// and float -> int conversions that truncate as astype(int32) does.
//
// Bound on the H100: memory, and mostly latency. A frame's work is a few
// thousand gathered bytes and ~40 flops per output pixel, so neither HBM's
// 3.35 TB/s nor the fp32 rate is near: the least time is the output bytes
// plus the distinct 32-byte sectors of source rows the gather touches, over
// the memory rate (chip_smoke.py computes it from the run's boxes).
//
// Design: one block of 256 threads per frame (the grid runs over the
// flattened leading axes). Pass 1: threads stride over the canvas pixels
// inside the letterbox, blend all C channels of a pixel from the frame (its
// rows are read through L1/L2: the gather of neighbouring pixels shares
// rows), write the rounded bytes to a shared-memory canvas and sum them per
// channel in integers (exact: at most 44*44*255 < 2^24). A block reduction
// (warp shuffles, then one shared atomic per warp and channel) gives the pad
// colour. Pass 2: threads stride over the th*tw*C outputs in order, so the
// stores are coalesced, and write the canvas byte, the pad colour or 0, as
// uint8 or as float32 / 255 (multiplied by the rounded reciprocal, as a
// PyTorch division by a scalar runs on the card).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 4;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

template <bool kNormalize>
__global__ void __launch_bounds__(kThreads)
crop_resize_pad_kernel(const uint8_t* __restrict__ frames, const int* __restrict__ boxes,
                       void* __restrict__ out, int H, int W, int C, int th, int tw) {
  extern __shared__ uint8_t canvas[];  // th * tw * C
  __shared__ int sums[kMaxChannels];
  const int64_t n = blockIdx.x;
  const uint8_t* frame = frames + n * static_cast<int64_t>(H) * W * C;
  const int bx0 = boxes[4 * n + 0], by0 = boxes[4 * n + 1], bx1 = boxes[4 * n + 2], by1 = boxes[4 * n + 3];
  if (threadIdx.x < kMaxChannels) sums[threadIdx.x] = 0;

  const float x_min = static_cast<float>(bx0), y_min = static_cast<float>(by0);
  const float cw = __fsub_rn(static_cast<float>(bx1), x_min);
  const float ch = __fsub_rn(static_cast<float>(by1), y_min);
  const bool valid = cw > 0.0f && ch > 0.0f;
  const float cw_s = fmaxf(cw, 1.0f), ch_s = fmaxf(ch, 1.0f);
  const int cwi = max(bx1 - bx0, 1), chi = max(by1 - by0, 1);
  const bool wide = cwi * th > chi * tw;
  const int new_w = max(wide ? tw : (th * cwi) / chi, 1);
  const int new_h = max(wide ? (tw * chi) / cwi : th, 1);
  const int ph = (th - new_h) / 2, pw = (tw - new_w) / 2;
  const float scale_y = __fdiv_rn(ch_s, static_cast<float>(new_h));
  const float scale_x = __fdiv_rn(cw_s, static_cast<float>(new_w));
  const int y_last = min(static_cast<int>(__fadd_rn(y_min, ch_s)) - 1, H - 1);
  const int x_last = min(static_cast<int>(__fadd_rn(x_min, cw_s)) - 1, W - 1);
  __syncthreads();  // sums zeroed

  int local[kMaxChannels] = {0, 0, 0, 0};
  const int region = new_h * new_w;
  for (int p = threadIdx.x; p < region; p += kThreads) {
    const int ri = p / new_w, rj = p - ri * new_w;
    const float sy = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(ri), 0.5f), scale_y), 0.5f);
    const float sx = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(rj), 0.5f), scale_x), 0.5f);
    const float src_y = fminf(fmaxf(__fadd_rn(fminf(fmaxf(sy, 0.0f), __fsub_rn(ch_s, 1.0f)), y_min), 0.0f),
                              static_cast<float>(H - 1));
    const float src_x = fminf(fmaxf(__fadd_rn(fminf(fmaxf(sx, 0.0f), __fsub_rn(cw_s, 1.0f)), x_min), 0.0f),
                              static_cast<float>(W - 1));
    const int y0 = static_cast<int>(floorf(src_y)), x0 = static_cast<int>(floorf(src_x));
    const int y1 = min(y0 + 1, y_last), x1 = min(x0 + 1, x_last);
    const float wy = __fsub_rn(src_y, static_cast<float>(y0)), wx = __fsub_rn(src_x, static_cast<float>(x0));
    const float wy1 = __fsub_rn(1.0f, wy), wx1 = __fsub_rn(1.0f, wx);
    // gather rows clamped into the frame, as XLA's gather clamps its indices
    const uint8_t* r0 = frame + static_cast<int64_t>(clampi(y0, 0, H - 1)) * W * C;
    const uint8_t* r1 = frame + static_cast<int64_t>(clampi(y1, 0, H - 1)) * W * C;
    const int c0 = clampi(x0, 0, W - 1) * C, c1 = clampi(x1, 0, W - 1) * C;
    uint8_t* dst = canvas + ((ri + ph) * tw + (rj + pw)) * C;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c >= C) break;
      // (((p00*(1-wy))*(1-wx) + (p01*(1-wy))*wx) + (p10*wy)*(1-wx)) + (p11*wy)*wx
      const float p00 = r0[c0 + c], p01 = r0[c1 + c], p10 = r1[c0 + c], p11 = r1[c1 + c];
      float s = __fmul_rn(__fmul_rn(p00, wy1), wx1);
      s = __fadd_rn(s, __fmul_rn(__fmul_rn(p01, wy1), wx));
      s = __fadd_rn(s, __fmul_rn(__fmul_rn(p10, wy), wx1));
      s = __fadd_rn(s, __fmul_rn(__fmul_rn(p11, wy), wx));
      const int v = static_cast<int>(fminf(fmaxf(rintf(s), 0.0f), 255.0f));
      dst[c] = static_cast<uint8_t>(v);
      local[c] += v;
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    int v = local[c];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) == 0 && c < C) atomicAdd(&sums[c], v);
  }
  __syncthreads();  // canvas and sums complete

  float avg[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c)
    avg[c] = c < C ? floorf(__fdiv_rn(static_cast<float>(sums[c]), static_cast<float>(region))) : 0.0f;
  const int total = th * tw * C;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int pix = e / C, c = e - pix * C;
    const int i = pix / tw - ph, j = pix - (pix / tw) * tw - pw;
    const bool inside = i >= 0 && i < new_h && j >= 0 && j < new_w;
    float pad = avg[0];
#pragma unroll
    for (int k = 1; k < kMaxChannels; ++k) pad = c == k ? avg[k] : pad;
    int v = inside ? canvas[e] : static_cast<int>(pad);
    if (!valid) v = 0;
    if (kNormalize) {
      // x / 255 as PyTorch divides by a scalar on the card: times its
      // reciprocal (so the kernel matches the plain version there bit for bit)
      static_cast<float*>(out)[n * total + e] = __fmul_rn(static_cast<float>(v), 1.0f / 255.0f);
    } else {
      static_cast<uint8_t*>(out)[n * total + e] = static_cast<uint8_t>(v);
    }
  }
}

}  // namespace

// frames (n, H, W, C) uint8, boxes (n, 4) int32, out (n, th, tw, C) uint8 or
// float32 (normalize); all contiguous on the device. Returns the launch's
// CUDA error (0 = success).
extern "C" int mlt_crop_resize_pad(const void* frames, const void* boxes, void* out, long long n, int H, int W,
                                   int C, int th, int tw, int normalize, void* stream) {
  if (n <= 0 || n > 2147483647LL || H <= 0 || W <= 0 || C <= 0 || C > kMaxChannels || th <= 0 || tw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(th) * tw * C;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n));
  auto s = static_cast<cudaStream_t>(stream);
  if (normalize) {
    crop_resize_pad_kernel<true><<<grid, kThreads, smem, s>>>(static_cast<const uint8_t*>(frames),
                                                             static_cast<const int*>(boxes), out, H, W, C, th, tw);
  } else {
    crop_resize_pad_kernel<false><<<grid, kThreads, smem, s>>>(static_cast<const uint8_t*>(frames),
                                                              static_cast<const int*>(boxes), out, H, W, C, th, tw);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch of one frame, into info[0..6): threads per block, dynamic
// shared memory bytes (th*tw*C), static shared memory bytes, registers per
// thread, local (spill) bytes per thread, blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns the first CUDA
// error (0 = success).
extern "C" int mlt_crop_resize_pad_launch_config(int th, int tw, int C, int normalize, int* info) {
  cudaFuncAttributes attr;
  const size_t smem = static_cast<size_t>(th) * tw * C;
  const void* fn = normalize ? reinterpret_cast<const void*>(crop_resize_pad_kernel<true>)
                             : reinterpret_cast<const void*>(crop_resize_pad_kernel<false>);
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int values[6] = {kThreads, static_cast<int>(smem), static_cast<int>(attr.sharedSizeBytes), attr.numRegs,
                         static_cast<int>(attr.localSizeBytes), per_sm};
  for (int i = 0; i < 6; ++i) info[i] = values[i];
  return 0;
}
