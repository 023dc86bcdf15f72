// Log-mel spectrogram frontend for Hopper (sm_90a): fp32 FMAs on the CUDA
// cores, one launch per call, standardization included.
//
// Replaces multimodal_lipread_tpu/ops/logmel_pallas.py::log_mel_pallas (the
// Pallas TPU kernel _logmel_kernel). Same function, per clip of 20 000 samples:
//   reflect pad 200 -> 126 frames of 400 samples at hop 160
//   -> windowed DFT (x @ [cos | -sin] basis, window L2 normalization folded in)
//   -> power re^2 + im^2 (201 frequencies) -> HTK mel filterbank (201 -> 80)
//   -> log(x + 1e-9) -> (80, 126), optionally standardized per clip
//      ((x - mean) / (std + 1e-9), std with ddof=1).
// Plain version: multimodal_lipread_torch/ops/logmel.py::log_mel_reference.
//
// Numerics: true fp32 FMAs, no TF32 and no bf16. At spectral nulls log()
// amplifies the rounding of the DFT's cancelling sums, and two fp32 versions
// that sum in different orders disagree there by about 1e-4 in log space
// (measured on the H100 with one 400-tap sum per frequency; 3xTF32 with fp32
// accumulation sits 9.3e-5 away in a CPU emulation). So the kernel sums as
// the framing-free split-GEMM of the TPU kernel and the plain version do:
// three partial DFTs over hop blocks of 160, 160 and 80 taps, each from zero
// in tap order by FMA, added as (P0 + P1) + P2; the power rounds its two
// products apart. Only the mel and standardization sums (positive terms, or
// fp64) are free in their order.
//
// Bound on the H100 SXM: the DFT at 201 frequencies and the nonzero mel
// weights (393 of 201 x 80) need 2*126*400*402 + 2*126*393 = 40.62 MFLOP per
// clip, 19.4 us at B=32 at the 67 TFLOP/s fp32 (non-tensor) peak. Bytes (80 KB
// of waveform and 40 KB of output per clip, 0.7 MB of tables) take ~1.4 us at
// B=32 at 3.35 TB/s. The kernel is bound by fp32 operations. Behind them is
// shared memory: an SM reads 128 bytes of it a cycle against 128 FMAs, and a
// thread's operand loads cost the same whether or not its neighbours read
// the same address, so a thread must do about one FMA per byte it loads.
//
// Design:
// - Grid (4 frame tiles of 32, B clips), 224 threads = 7 warps, one block per
//   SM: B=32 fills 128 of the 132 SMs in one wave. A warp computes 32 frames
//   x 32 frequencies: lane = 4 frame groups x 8 frequency groups; a thread
//   owns frames g, g+4, ..., g+28 and 4 consecutive frequencies, re and im:
//   64 accumulators. 201 frequencies pad to 7 x 32 = 224 columns per half.
// - Per tap a thread reads its 4 cos and 4 sin basis values as two float4
//   (LDS.128) and, every 4 taps, its 8 frames' samples as one float4 each:
//   64 bytes and 4 shared-memory loads per 64 FMAs (the first port read 18
//   per 56). The next 4 taps' samples and the next tap's basis values load
//   while this tap's FMAs run. The staged waveform keeps hop blocks 164
//   floats apart, so the 4 frame groups' float4 loads fall in distinct bank
//   quads; each basis LDS.128 reads 128 contiguous bytes.
// - Each hop block's partial DFT starts from zero in registers; the sum of
//   the finished ones waits in shared memory (56 KB, one slot per thread and
//   value), which keeps the kernel at 167 registers and no spills.
// - The basis, (400, 448) row-major, streams through a ring of 4 stages of 16
//   taps (28 KB each) in dynamic shared memory. Thread 0 issues each chunk as
//   one TMA bulk copy (cp.async.bulk) completing on the stage's "full"
//   mbarrier; each warp arrives on the stage's "empty" mbarrier when done
//   with it, and warp 0 refills the stage 4 chunks ahead: one wait per chunk,
//   no block barrier. Chunks never straddle a hop block. The waveform stretch
//   of the tile (34 hop blocks, reflect padding by index arithmetic, float4
//   loads inside the clip) and the mel bands are staged while the first
//   chunks are in flight.
// - The power tile goes to shared memory (over the ring). A mel filter sums
//   its band of 16 frequencies (its nonzero weights and zeros, which add
//   exactly nothing), without branches; lanes on consecutive frames, so the
//   stores to (80, 126) are coalesced.
// - Standardization in the same launch: each block leaves the fp64 sum of
//   its log-mel values in `partials` and takes a ticket for its clip; the
//   clip's last block reads the clip back from L2, sums the centred squares
//   in fp64 and writes it standardized. (A thread block cluster per clip was
//   built and measured first: 4-block clusters at one block per SM fit only
//   30 at once on the H100, so B=32 ran in two waves. PERF.md.)

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSamples = 20000;
constexpr int kPad = 200;                         // n_fft / 2, reflect
constexpr int kPadded = kSamples + 2 * kPad;      // 20400
constexpr int kHop = 160;
constexpr int kNfft = 400;
constexpr int kFrames = 126;
constexpr int kFreqs = 201;
constexpr int kMels = 80;
constexpr int kMelBand = 16;                      // frequencies in a mel filter's band (widest filter: 14)

constexpr int kFramesPerThread = 8;
constexpr int kFreqsPerThread = 4;                // one float4 of cos, one of -sin
constexpr int kFrameLanes = 4;                    // a warp: 4 frame groups
constexpr int kFreqLanes = 32 / kFrameLanes;      //       x 8 frequency groups
constexpr int kWarpFreqs = kFreqLanes * kFreqsPerThread;          // 32
constexpr int kWarps = (kFreqs + kWarpFreqs - 1) / kWarpFreqs;    // 7
constexpr int kFreqCols = kWarps * kWarpFreqs;    // 201 frequencies padded to 224
constexpr int kBasisCols = 2 * kFreqCols;         // cos | -sin
constexpr int kThreads = 32 * kWarps;                             // 224
constexpr int kTileFrames = kFrameLanes * kFramesPerThread;       // 32
constexpr int kTiles = (kFrames + kTileFrames - 1) / kTileFrames; // 4
constexpr int kAcc = 2 * kFramesPerThread * kFreqsPerThread;      // 64 per thread

constexpr int kSegBlocks = kTileFrames + 2;       // hop blocks the tile's frames cover
constexpr int kSegStride = kHop + 4;              // 164: 16 bytes of bank offset per block
constexpr int kChunk = 16;                        // basis rows (taps) per stage
constexpr int kStages = 4;
constexpr int kAhead = 1;                         // taps of basis values loaded ahead of their FMAs
constexpr int kChunks = kNfft / kChunk;                           // 25
constexpr int kChunkFloats = kChunk * kBasisCols;
constexpr uint32_t kChunkBytes = kChunkFloats * sizeof(float);    // 28 672
constexpr int kRingFloats = kStages * kChunkFloats;
constexpr int kSegFloats = kSegBlocks * kSegStride;
constexpr int kStashFloats = kAcc * kThreads;
constexpr size_t kSmemBytes =
    (kRingFloats + kSegFloats + kStashFloats + kMels * kMelBand + kMels) * sizeof(float) +
    2 * kStages * sizeof(uint64_t);
constexpr int kPowStride = kFreqs + 8;            // 209, odd: lanes on frames hit distinct banks
constexpr int kMelsPerThread = (kMels + kWarps - 1) / kWarps;     // 12
constexpr int kNormCount = kMels * kFrames;
constexpr int kSegVecs = kSegBlocks * kHop / 4;   // the staged stretch in float4
constexpr int kStagePerThread = (kSegVecs + kThreads - 1) / kThreads;
constexpr int kNormVecs = kNormCount / 4;
constexpr int kNormVecsPerThread = (kNormVecs + kThreads - 1) / kThreads;  // 12

static_assert(kHop % kChunk == 0 && (kNfft - 2 * kHop) % kChunk == 0, "chunks must not straddle hop blocks");
static_assert(kChunk % 4 == 0 && kSegStride % 4 == 0 && kFreqCols % 4 == 0, "float4 alignment");
static_assert(kChunkBytes % 16 == 0 && (kRingFloats * sizeof(float)) % 16 == 0, "bulk copies move 16-byte units");
static_assert(kTileFrames * kPowStride <= kRingFloats, "the power tile reuses the ring");
static_assert(kFrameLanes * kFreqLanes == 32 && kFreqCols >= kFreqs, "warp layout");
static_assert(kTileFrames == 32, "mel stage: one lane per frame of the tile");
static_assert(kHop % 4 == 0 && kPad % 4 == 0 && kSamples % 4 == 0 && kNormCount % 4 == 0, "float4 staging");
static_assert(kChunks > kStages, "the ring is refilled");
static_assert((kRingFloats + kSegFloats + kStashFloats) % 4 == 0 && (kMels * kMelBand + kMels) % 2 == 0,
              "float4 mel bands, 8-byte aligned mbarriers");
static_assert(kSmemBytes <= 232448, "shared memory of one block on the H100");

// Optional timestamps (ns, %globaltimer) per block: start, waveform staged,
// DFT done, mel done, ticket taken (tile written, without normalize), and
// the clip standardized (its last block only).
constexpr int kPhases = 6;

constexpr float kLogEps = 1e-9f;
constexpr float kNormEps = 1e-9f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA bulk copy of basis chunk `c` into `dst`, completing on `bar`.
__device__ __forceinline__ void load_chunk(const float* basis, int c, float* dst, uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(kChunkBytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(basis + static_cast<size_t>(c) * kChunkFloats), "r"(kChunkBytes), "r"(b)
      : "memory");
}

// atomicAdd with release (this block's writes before it) and acquire (the
// other blocks' writes before theirs) at device scope.
__device__ __forceinline__ int ticket_add(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(p) : "memory");
  return old;
}

// Frame fg + kFrameLanes * r's samples at taps t .. t + 3 (t % 4 == 0) of the chunk.
__device__ __forceinline__ float4 load_samples(const float* arow, int r, int t) {
  return *reinterpret_cast<const float4*>(arow + r * kFrameLanes * kSegStride + t);
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ void stamp(unsigned long long* stamps, int phase) {
  if (stamps != nullptr && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[(blockIdx.y * gridDim.x + blockIdx.x) * kPhases + phase] = t;
  }
}

// fp64 sum of `v` over the block, in the same order on every run; every
// thread gets the total.
__device__ double block_sum(double v, double* warp_part) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = v;
  __syncthreads();
  double total = 0.0;
  for (int w = 0; w < kWarps; ++w) total += warp_part[w];
  __syncthreads();  // warp_part is reused by the next call
  return total;
}

__global__ void __launch_bounds__(kThreads, 1)
logmel_kernel(const float* __restrict__ wave, const float* __restrict__ basis,
              const int* __restrict__ mel_first, const float* __restrict__ mel_bands,
              float* __restrict__ out, double* __restrict__ partials, int* __restrict__ tickets,
              unsigned long long* __restrict__ stamps, int normalize) {
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;                     // kStages basis chunks, then the power tile
  float* seg = ring + kRingFloats;        // hop blocks f0 .. f0 + kSegBlocks of the padded wave
  float* stash = seg + kSegFloats;        // finished hop blocks' DFT sums, [value][thread]
  float* band_w = stash + kStashFloats;   // filter m: weights of frequencies band_first[m] + 0..15
  int* band_first = reinterpret_cast<int*>(band_w + kMels * kMelBand);
  uint64_t* full = reinterpret_cast<uint64_t*>(band_first + kMels);
  uint64_t* empty = full + kStages;
  __shared__ double warp_part[kWarps];
  __shared__ int last;

  const int tile = blockIdx.x;
  const int clip = blockIdx.y;
  const int f0 = tile * kTileFrames;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  stamp(stamps, 0);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < kStages; ++c) load_chunk(basis, c, ring + c * kChunkFloats, &full[c]);
  }

  // Stage padded samples f0 * hop .. + kSegBlocks * hop, four at a time:
  // whole float4 of the waveform inside it, sample by sample (reflect, or 0
  // past the padded end: frames >= 126, discarded below) at its edges.
  const float* x = wave + static_cast<size_t>(clip) * kSamples;
  float4 staged[kStagePerThread];
#pragma unroll
  for (int j = 0; j < kStagePerThread; ++j) {  // all loads first, then the stores
    const int v = tid + j * kThreads;
    const int i0 = f0 * kHop + 4 * v - kPad;   // waveform index of the first of the four
    if (v < kSegVecs && i0 >= 0 && i0 + 4 <= kSamples) {
      staged[j] = __ldg(reinterpret_cast<const float4*>(x + i0));
    } else {
      float e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int i = i0 + k;
        e[k] = 0.f;
        if (v < kSegVecs && i < kSamples + kPad) {
          i = i < 0 ? -i : i;
          i = i >= kSamples ? 2 * (kSamples - 1) - i : i;
          e[k] = __ldg(x + i);
        }
      }
      staged[j] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < kStagePerThread; ++j) {
    const int v = tid + j * kThreads;
    const int b = 4 * v / kHop;
    if (v < kSegVecs) *reinterpret_cast<float4*>(seg + b * kSegStride + 4 * v - b * kHop) = staged[j];
  }
  for (int i = tid; i < kMels * kMelBand / 4; i += kThreads)
    reinterpret_cast<float4*>(band_w)[i] = __ldg(reinterpret_cast<const float4*>(mel_bands) + i);
  for (int i = tid; i < kMels; i += kThreads) band_first[i] = __ldg(mel_first + i);
  __syncthreads();  // segment and mel bands staged, barriers initialised
  stamp(stamps, 1);

  const int fg = lane % kFrameLanes;
  const int col = warp * kWarpFreqs + (lane / kFrameLanes) * kFreqsPerThread;  // the thread's first column
  float re[kFramesPerThread][kFreqsPerThread], im[kFramesPerThread][kFreqsPerThread];
  float* my_stash = stash + tid;

  int c = 0;
  for (int h = 0; h < 3; ++h) {  // hop blocks of 160, 160 and 80 taps
#pragma unroll
    for (int r = 0; r < kFramesPerThread; ++r) {
#pragma unroll
      for (int j = 0; j < kFreqsPerThread; ++j) re[r][j] = im[r][j] = 0.f;
    }
    const int taps = h < 2 ? kHop : kNfft - 2 * kHop;
    const float* a_base = seg + (fg + h) * kSegStride;  // frame fg + 4r reads hop block fg + 4r + h
    for (int k0 = 0; k0 < taps; k0 += kChunk, ++c) {
      const int stage = c % kStages;
      const uint32_t parity = (c / kStages) & 1;
      mbar_wait(&full[stage], parity);
      const float* brow = ring + stage * kChunkFloats + col;
      const float* arow = a_base + k0;
      // Taps in order, operands loaded ahead of their FMAs: the samples of
      // the next 4 taps, the basis values of the tap kAhead on.
      float4 a[2][kFramesPerThread];
      float4 cs[kAhead + 1], sn[kAhead + 1];
#pragma unroll
      for (int r = 0; r < kFramesPerThread; ++r) a[0][r] = load_samples(arow, r, 0);
#pragma unroll
      for (int t = 0; t < kAhead; ++t) {
        cs[t] = *reinterpret_cast<const float4*>(brow + t * kBasisCols);
        sn[t] = *reinterpret_cast<const float4*>(brow + t * kBasisCols + kFreqCols);
      }
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        if (t % 4 == 0 && t + 4 < kChunk) {
#pragma unroll
          for (int r = 0; r < kFramesPerThread; ++r) a[(t / 4 + 1) % 2][r] = load_samples(arow, r, t + 4);
        }
        if (t + kAhead < kChunk) {
          const int nxt = (t + kAhead) % (kAhead + 1);
          cs[nxt] = *reinterpret_cast<const float4*>(brow + (t + kAhead) * kBasisCols);
          sn[nxt] = *reinterpret_cast<const float4*>(brow + (t + kAhead) * kBasisCols + kFreqCols);
        }
        const float4 c4 = cs[t % (kAhead + 1)], s4 = sn[t % (kAhead + 1)];
#pragma unroll
        for (int r = 0; r < kFramesPerThread; ++r) {
          const float av = lane_of(a[(t / 4) % 2][r], t % 4);
          re[r][0] = fmaf(av, c4.x, re[r][0]);
          re[r][1] = fmaf(av, c4.y, re[r][1]);
          re[r][2] = fmaf(av, c4.z, re[r][2]);
          re[r][3] = fmaf(av, c4.w, re[r][3]);
          im[r][0] = fmaf(av, s4.x, im[r][0]);
          im[r][1] = fmaf(av, s4.y, im[r][1]);
          im[r][2] = fmaf(av, s4.z, im[r][2]);
          im[r][3] = fmaf(av, s4.w, im[r][3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (warp == 0) {  // the whole warp waits, so it does not diverge
        if (lane == 0 && c + kStages < kChunks) {
          mbar_wait(&empty[stage], parity);  // every warp is done with chunk c
          load_chunk(basis, c + kStages, ring + stage * kChunkFloats, &full[stage]);
        }
        __syncwarp();
      }
    }
    // (P0 + P1) + P2, the plain version's order; the running sum waits in
    // the stash, and after P2 the spectrum is in re, im.
#pragma unroll
    for (int r = 0; r < kFramesPerThread; ++r) {
#pragma unroll
      for (int j = 0; j < kFreqsPerThread; ++j) {
        float* sr = my_stash + (2 * (r * kFreqsPerThread + j)) * kThreads;
        float* si = sr + kThreads;
        if (h == 0) {
          *sr = re[r][j];
          *si = im[r][j];
        } else if (h == 1) {
          *sr = *sr + re[r][j];
          *si = *si + im[r][j];
        } else {
          re[r][j] = *sr + re[r][j];
          im[r][j] = *si + im[r][j];
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the ring before the power tile overwrites it
  stamp(stamps, 2);

  float* pw = ring;
#pragma unroll
  for (int r = 0; r < kFramesPerThread; ++r) {
#pragma unroll
    for (int j = 0; j < kFreqsPerThread; ++j) {
      const int f = col + j;
      if (f < kFreqs) {
        const float xr = re[r][j], xi = im[r][j];
        // products rounded apart, as the plain version's re*re + im*im
        pw[(fg + r * kFrameLanes) * kPowStride + f] = __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi));
      }
    }
  }
  __syncthreads();

  // Mel: lane -> frame, warp -> filters warp, warp + kWarps, ... (band
  // reads are warp-uniform broadcasts).
  const int frame = f0 + lane;
  const float* prow = pw + lane * kPowStride;
  float vals[kMelsPerThread];
  double s = 0.0;  // fp64 sum of the tile's values
#pragma unroll
  for (int q = 0; q < kMelsPerThread; ++q) {
    const int m = warp + q * kWarps;
    const int mm = m < kMels ? m : kMels - 1;  // slots past the last filter repeat it, unused
    const float* p = prow + band_first[mm];
    const float4* w = reinterpret_cast<const float4*>(band_w + mm * kMelBand);
    float acc = 0.f;
#pragma unroll
    for (int j4 = 0; j4 < kMelBand / 4; ++j4) {
      const float4 wv = w[j4];
      acc = fmaf(p[4 * j4 + 0], wv.x, acc);
      acc = fmaf(p[4 * j4 + 1], wv.y, acc);
      acc = fmaf(p[4 * j4 + 2], wv.z, acc);
      acc = fmaf(p[4 * j4 + 3], wv.w, acc);
    }
    vals[q] = logf(acc + kLogEps);
    if (m < kMels && frame < kFrames) s += vals[q];
  }

  stamp(stamps, 3);
  float* o = out + static_cast<size_t>(clip) * kNormCount;
  if (frame < kFrames) {
#pragma unroll
    for (int q = 0; q < kMelsPerThread; ++q) {
      const int m = warp + q * kWarps;
      if (m < kMels) o[m * kFrames + frame] = vals[q];
    }
  }
  if (!normalize) {
    stamp(stamps, 4);
    return;
  }

  // Standardization: each block leaves the fp64 sum of its values in
  // `partials`; the last of the clip's blocks to take its ticket reads the
  // clip back from L2, sums the centred squares in fp64, writes the clip
  // standardized and resets the ticket.
  const double tile_sum = block_sum(s, warp_part);  // its barriers order the block's stores before the ticket
  if (tid == 0) {
    partials[clip * kTiles + tile] = tile_sum;
    last = ticket_add(&tickets[clip]) == kTiles - 1;
  }
  __syncthreads();
  stamp(stamps, 4);
  if (!last) return;

  double clip_sum = 0.0;
  for (int t = 0; t < kTiles; ++t) clip_sum += __ldcg(partials + clip * kTiles + t);
  const float mean = static_cast<float>(clip_sum / kNormCount);
  float4* o4 = reinterpret_cast<float4*>(o);
  float4 v[kNormVecsPerThread];
#pragma unroll
  for (int j = 0; j < kNormVecsPerThread; ++j) {
    const int i = tid + j * kThreads;
    v[j] = i < kNormVecs ? __ldcg(o4 + i) : make_float4(mean, mean, mean, mean);  // padding adds 0 below
  }
  double sq = 0.0;
#pragma unroll
  for (int j = 0; j < kNormVecsPerThread; ++j) {
    const float d[4] = {v[j].x - mean, v[j].y - mean, v[j].z - mean, v[j].w - mean};
#pragma unroll
    for (int k = 0; k < 4; ++k) sq += static_cast<double>(d[k]) * d[k];
  }
  const float stdev = static_cast<float>(sqrt(block_sum(sq, warp_part) / (kNormCount - 1)));
  const float denom = stdev + kNormEps;
#pragma unroll
  for (int j = 0; j < kNormVecsPerThread; ++j) {
    const int i = tid + j * kThreads;
    if (i < kNormVecs)
      o4[i] = make_float4((v[j].x - mean) / denom, (v[j].y - mean) / denom, (v[j].z - mean) / denom,
                          (v[j].w - mean) / denom);
  }
  if (tid == 0) tickets[clip] = 0;
  stamp(stamps, 5);
}

// Raises the kernel's dynamic shared memory limit, once per device.
cudaError_t configure() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace

// wave (B, 20000) f32; basis (400, 512) f32 [cos | -sin], 201 of each 256
// columns nonzero; mel_first (80,) int32 and mel_bands (80, 16) f32: filter m
// weighs frequency mel_first[m] + j by mel_bands[m][j], zero outside the
// filter, mel_first[m] <= 185; out (B, 80, 126) f32; for
// normalize, partials (B, 4) f64 scratch and tickets (B,) int32, zero before
// the launch and left zero by it; stamps null, or (B, 4, 6) u64 for the
// blocks' phase timestamps. All contiguous, on the current device. One
// launch on `stream`; returns cudaGetLastError() after it (0 = success).
extern "C" int mlt_logmel_forward(const float* wave, const float* basis, const int* mel_first,
                                  const float* mel_bands, float* out, double* partials, int* tickets,
                                  unsigned long long* stamps, int batch, int normalize, void* stream) {
  if (batch <= 0 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  logmel_kernel<<<dim3(kTiles, batch), kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      wave, basis, mel_first, mel_bands, out, partials, tickets, stamps, normalize);
  return static_cast<int>(cudaGetLastError());
}

// The launch of `batch` clips, into info[0..9): grid x, grid y, threads per
// block, dynamic shared memory bytes, static shared memory bytes, registers
// per thread, local (spill) bytes per thread, blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and how many clusters of
// one clip's 4 blocks could be resident at once if the kernel were launched
// in such clusters (cudaOccupancyMaxActiveClusters): the measure that ruled
// out a cluster per clip. Returns the first CUDA error (0 = success).
extern "C" int mlt_logmel_launch_config(int batch, int* info) {
  cudaError_t err = configure();
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, logmel_kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, logmel_kernel, kThreads, kSmemBytes);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kTiles;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.gridDim = dim3(kTiles, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, logmel_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int values[9] = {kTiles, batch, kThreads, static_cast<int>(kSmemBytes),
                         static_cast<int>(attr.sharedSizeBytes), attr.numRegs,
                         static_cast<int>(attr.localSizeBytes), per_sm, clusters};
  for (int i = 0; i < 9; ++i) info[i] = values[i];
  return 0;
}
