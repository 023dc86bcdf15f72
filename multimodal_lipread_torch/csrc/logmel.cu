// Log-mel spectrogram frontend for Hopper (sm_90a): fp32 FMAs on the CUDA cores.
//
// Replaces multimodal_lipread_tpu/ops/logmel_pallas.py::log_mel_pallas (the
// Pallas TPU kernel _logmel_kernel). Same function, per clip of 20 000 samples:
//   reflect pad 200 -> 126 frames of 400 samples at hop 160
//   -> windowed DFT (x @ [cos | -sin] basis, window L2 normalization folded in)
//   -> power re^2 + im^2 (201 frequencies) -> @ HTK mel filterbank (201, 80)
//   -> log(x + 1e-9) -> (80, 126), optionally standardized per clip
//      ((x - mean) / (std + 1e-9), std with ddof=1).
// Plain version: multimodal_lipread_torch/ops/logmel.py::log_mel_reference.
//
// Numerics: true fp32 FMAs, no TF32 and no bf16. Reduced precision breaks the
// power-spectrum cancellation at spectral nulls, which log() then amplifies
// (the TPU kernel needs Precision.HIGHEST for the same reason). Even two fp32
// versions disagree there by more than 1e-4 in log space when they sum in
// different orders (measured on the H100 at B=128 with one 400-tap sum per
// frequency). So the kernel sums as the framing-free split-GEMM of the TPU
// kernel and the plain version does: three partial DFTs over hop blocks of
// 160, 160 and 80 taps, each accumulated in tap order by FMA, added as
// (P0 + P1) + P2; the power rounds its two products apart.
//
// Bound on the H100 SXM: the DFT and mel products need
//   2*126*400*402 + 2*126*201*80 = 44.57 MFLOP per clip (no zero padding),
// so 1.43 GFLOP at B=32, 21.3 us at the 67 TFLOP/s fp32 (non-tensor) peak,
// and 85.1 us at B=128. Bytes are 80 KB of waveform and 40 KB of output per
// clip plus 0.78 MB of tables: ~1.4 us at B=32 at 3.35 TB/s. The kernel is
// compute-bound. (The JAX cost estimate counts the zero-padded basis, 67.09
// MFLOP per clip, i.e. 32 us at B=32.)
//
// Design:
// - Framing by index arithmetic. Each block stages in shared memory the
//   stretch of the reflect-padded waveform its frames cover, reading the raw
//   (B, 20000) waveform; no frame or block tensor exists in device memory.
// - Grid (4 frame tiles of 32, B clips), 256 threads. The block computes a
//   32 x 448 DFT tile (201 frequencies padded to 224, cos and sin halves) over
//   K = 400 taps, staging the basis through shared memory 8 rows at a time.
//   Each thread holds 4 frames x 7 frequencies of both re and im, and their
//   sums over finished hop blocks, so the power is formed in registers before
//   anything leaves the block. (194 registers: one block of 8 warps per SM.)
// - The power tile goes to shared memory, the 80 mel sums per frame read the
//   filterbank through the read-only cache, log() and the transposed store
//   to (80, 126) follow, with lanes on consecutive frames.
// - Per-clip standardization needs all 80 x 126 values of a clip. A grid over
//   (clip, frame tile) fills the 132 SMs at B=32 (128 blocks, where one block
//   per clip would give 32), so the reduction is a second small launch, one
//   block per clip, in place, summing in fp64.
// Making it fast (3xTF32 on wgmma, TMA staging, double buffering) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kSamples = 20000;
constexpr int kPad = 200;                         // n_fft / 2, reflect
constexpr int kPadded = kSamples + 2 * kPad;      // 20400
constexpr int kHop = 160;
constexpr int kNfft = 400;
constexpr int kFrames = 126;
constexpr int kFreqs = 201;
constexpr int kFreqCols = 224;                    // 201 frequencies padded to 7 x 32
constexpr int kBasisCols = 2 * kFreqCols;         // cos | -sin
constexpr int kMels = 80;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileFrames = 32;
constexpr int kTiles = (kFrames + kTileFrames - 1) / kTileFrames;  // 4
constexpr int kFramesPerThread = kTileFrames / kWarps;            // 4
constexpr int kFreqPerThread = kFreqCols / 32;                    // 7
constexpr int kSegLen = (kTileFrames - 1) * kHop + kNfft;         // 5360
constexpr int kChunk = 8;                                         // basis rows per stage
constexpr int kPowStride = kFreqCols + 1;                         // 225: conflict-free columns
constexpr int kMelsPerThread = kMels * kTileFrames / kThreads;    // 10
constexpr int kSmemFloats = kSegLen + kChunk * kBasisCols;        // 8944 (35.8 KB)

static_assert(kNfft % kChunk == 0 && kHop % kChunk == 0, "chunks must not straddle hop blocks");
static_assert(kSegLen % 4 == 0, "basis chunk must stay 16-byte aligned");
static_assert((kChunk * kBasisCols) % 4 == 0, "float4 staging");
static_assert(kTileFrames * kPowStride <= kSmemFloats, "power tile reuses the staging space");
static_assert(kMelsPerThread * kWarps == kMels, "mel split");

constexpr int kNormThreads = 256;
constexpr float kLogEps = 1e-9f;
constexpr float kNormEps = 1e-9f;

__global__ void __launch_bounds__(kThreads)
logmel_tile_kernel(const float* __restrict__ wave, const float* __restrict__ basis,
                   const float* __restrict__ fb, float* __restrict__ out) {
  __shared__ __align__(16) float smem[kSmemFloats];
  float* seg = smem;                  // padded samples [f0*hop, f0*hop + kSegLen)
  float* chunk = smem + kSegLen;      // basis rows [k0, k0 + kChunk)
  float* pw = smem;                   // power tile, after the DFT

  const int f0 = blockIdx.x * kTileFrames;
  const int clip = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* x = wave + static_cast<size_t>(clip) * kSamples;

  for (int s = tid; s < kSegLen; s += kThreads) {
    const int p = f0 * kHop + s;
    float v = 0.f;  // past the padded end: frames >= 126, discarded below
    if (p < kPadded) {
      int i = p - kPad;
      i = i < 0 ? -i : i;
      i = i >= kSamples ? 2 * (kSamples - 1) - i : i;
      v = x[i];
    }
    seg[s] = v;
  }

  // Thread (warp, lane) owns frames warp*4 + r and frequencies lane + 32*i.
  // (re, im) accumulate one hop block's partial DFT; (sum_re, sum_im) add the
  // partials as (P0 + P1) + P2, the plain version's order (see note above).
  float re[kFramesPerThread][kFreqPerThread], im[kFramesPerThread][kFreqPerThread];
  float sum_re[kFramesPerThread][kFreqPerThread], sum_im[kFramesPerThread][kFreqPerThread];
#pragma unroll
  for (int r = 0; r < kFramesPerThread; ++r) {
#pragma unroll
    for (int i = 0; i < kFreqPerThread; ++i) {
      re[r][i] = im[r][i] = sum_re[r][i] = sum_im[r][i] = 0.f;
    }
  }
  const float* a_base = seg + warp * kFramesPerThread * kHop;

  for (int k0 = 0; k0 < kNfft; k0 += kChunk) {
    if (k0 % kHop == 0 && k0 > 0) {  // a hop block's partial is complete
#pragma unroll
      for (int r = 0; r < kFramesPerThread; ++r) {
#pragma unroll
        for (int i = 0; i < kFreqPerThread; ++i) {
          sum_re[r][i] += re[r][i];
          sum_im[r][i] += im[r][i];
          re[r][i] = im[r][i] = 0.f;
        }
      }
    }
    __syncthreads();  // segment staged; previous chunk consumed
    const float4* src = reinterpret_cast<const float4*>(basis + static_cast<size_t>(k0) * kBasisCols);
    float4* dst = reinterpret_cast<float4*>(chunk);
    for (int v = tid; v < kChunk * kBasisCols / 4; v += kThreads) dst[v] = __ldg(src + v);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[kFramesPerThread];
#pragma unroll
      for (int r = 0; r < kFramesPerThread; ++r) a[r] = a_base[r * kHop + k0 + kk];
      const float* row = chunk + kk * kBasisCols + lane;
#pragma unroll
      for (int i = 0; i < kFreqPerThread; ++i) {
        const float c = row[32 * i];
        const float sn = row[kFreqCols + 32 * i];
#pragma unroll
        for (int r = 0; r < kFramesPerThread; ++r) {
          re[r][i] = fmaf(a[r], c, re[r][i]);
          im[r][i] = fmaf(a[r], sn, im[r][i]);
        }
      }
    }
  }
  __syncthreads();  // all reads of seg/chunk done before pw overwrites them
#pragma unroll
  for (int r = 0; r < kFramesPerThread; ++r) {
#pragma unroll
    for (int i = 0; i < kFreqPerThread; ++i) {
      const float x = sum_re[r][i] + re[r][i], y = sum_im[r][i] + im[r][i];
      // products rounded apart, as the plain version's re*re + im*im
      pw[(warp * kFramesPerThread + r) * kPowStride + lane + 32 * i] =
          __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
    }
  }
  __syncthreads();

  // Mel: lane -> frame, warp -> 10 consecutive mel bins (filterbank reads are
  // warp-uniform broadcasts).
  const int m0 = warp * kMelsPerThread;
  const float* prow = pw + lane * kPowStride;
  float acc[kMelsPerThread];
#pragma unroll
  for (int q = 0; q < kMelsPerThread; ++q) acc[q] = 0.f;
  for (int j = 0; j < kFreqs; ++j) {
    const float p = prow[j];
    const float* fbrow = fb + j * kMels + m0;
#pragma unroll
    for (int q = 0; q < kMelsPerThread; ++q) acc[q] = fmaf(p, __ldg(fbrow + q), acc[q]);
  }
  const int frame = f0 + lane;
  if (frame < kFrames) {
    float* o = out + static_cast<size_t>(clip) * kMels * kFrames + frame;
#pragma unroll
    for (int q = 0; q < kMelsPerThread; ++q) o[(m0 + q) * kFrames] = logf(acc[q] + kLogEps);
  }
}

// Tree sum over the block; every thread gets the total.
__device__ double block_sum(double v, double* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = kNormThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const double total = red[0];
  __syncthreads();  // red is reused by the next call
  return total;
}

__global__ void __launch_bounds__(kNormThreads) standardize_kernel(float* __restrict__ out) {
  __shared__ double red[kNormThreads];
  constexpr int n = kMels * kFrames;
  float* x = out + static_cast<size_t>(blockIdx.x) * n;
  const int tid = threadIdx.x;

  double s = 0.0;
  for (int i = tid; i < n; i += kNormThreads) s += x[i];
  const float mean = static_cast<float>(block_sum(s, red) / n);
  double q = 0.0;
  for (int i = tid; i < n; i += kNormThreads) {
    const float d = x[i] - mean;
    q += static_cast<double>(d) * d;
  }
  const float stdev = static_cast<float>(sqrt(block_sum(q, red) / (n - 1)));
  const float denom = stdev + kNormEps;
  for (int i = tid; i < n; i += kNormThreads) x[i] = (x[i] - mean) / denom;
}

}  // namespace

// wave (B, 20000) f32; basis (400, 448) f32 [cos | -sin], 201 of each 224
// columns nonzero; fb (201, 80) f32; out (B, 80, 126) f32. All contiguous, on
// the current device. Launches on `stream`; returns cudaGetLastError() after
// the launches (0 = success).
extern "C" int mlt_logmel_forward(const float* wave, const float* basis, const float* fb,
                                  float* out, int batch, int normalize, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  logmel_tile_kernel<<<dim3(kTiles, batch), kThreads, 0, s>>>(wave, basis, fb, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !normalize) return static_cast<int>(err);
  standardize_kernel<<<batch, kNormThreads, 0, s>>>(out);
  return static_cast<int>(cudaGetLastError());
}
