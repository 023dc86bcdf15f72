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
// rintf (half to even; roundf rounds half away from zero), IEEE divisions,
// float -> int conversions that truncate as astype(int32) does, and the
// normalize as a multiply by the rounded reciprocal of 255 (as PyTorch
// divides by a scalar on the card).
//
// What bounds it on the H100: the chain of dependent steps a frame's work
// waits on, and instruction issue. A frame is a few kilobytes of gathered
// source sectors, and ~107 instructions a letterboxed pixel (four byte taps
// a channel, the blend in the plain version's order), so neither HBM's
// 3.35 TB/s nor the fp32 rate is near (chip_smoke.py's bound is the output
// bytes plus the distinct 32-byte source sectors the gather needs, at the
// memory rate).
//
// The earlier design (the crop row's earlier time in PERF.md): one block of
// 256 threads per frame, each thread gathering ~8 pixels one after another
// straight from global memory (a dependent round each) and dividing by
// runtime sizes per pixel and per stored byte.
//
// This design: a cluster of K blocks per frame, each block owning a band of
// ceil(th / K) output rows. K = 2 with 128 threads a block by default:
// chip_smoke.py's [crop-kernel] times K = 1, 2, 4 and 8; at 464 frames every
// cluster of two is resident at once, K = 4 and 8 take two waves and more,
// K = 1 blends a band of 44 rows with two staging rounds.
//   1. Warp 0 reads the box and works out the letterbox. Then the last
//      warps write the column entries (source byte offsets and weights) of
//      up to 64 output columns while warp 0, one lane per output row, numbers
//      the band's distinct source rows (y0, y1 are non-decreasing, so a
//      ballot counts them) and takes the byte span of the columns,
//      [x0(first) * C, (x1(last) + 1) * C), widened to 16-byte alignment.
//   2. The rows x span are copied into shared memory in one round: every
//      16-byte cp.async.cg of the band in flight at once, in two commit
//      groups (the rows of the first half of the band, then the rest), so
//      the first half is blended while the second lands.
//   3. The band is blended from shared memory, a pixel a thread a pass, with
//      loops over rows and columns (no runtime division per pixel), bytes
//      made floats and sums rounded with integer and fp32 operations (not the
//      conversion unit), into a shared-memory copy of the band; the rounded
//      values are summed per channel in integers (exact, so the order does
//      not matter).
//   4. The blocks of the cluster exchange their sums through distributed
//      shared memory (each writes its sums into every peer, one cluster
//      barrier), so each has the frame's pad colour; they fill their band's
//      pad pixels and store it with 16-byte stores, coalesced (uint8, or 4
//      floats of the /255 from 4 bytes).
// Where a band's window does not fit the block's staging bytes (wide
// frames, large boxes) it is staged in rounds of fewer rows, and in column
// groups where even two rows do not fit; ops/crop_resize_cuda.staging_plan
// reckons the same rounds. The 16-byte copies may read up to 15 bytes
// before the first and after the last byte a row needs; they stay inside
// the 16-byte-aligned blocks that hold needed bytes, so inside the pages of
// the frames' allocation.
//
// What still holds it (PERF.md, the crop row): the blocks of a launch run
// in one wave, in step, so the memory round of all frames at once (2-3 us,
// near the bound) overlaps neither the box read and the row numbering
// before it nor the blend, the exchange and the stores after it; and at
// ~17 ns a frame in steady state, instruction issue alone takes ~8 us for
// 464 frames. Blocks that stay resident and pipeline several frames, with
// fewer instructions a pixel, are the next step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 65536 / 64 / kMaxThreads;  // at most 64 registers: 8 blocks of 128 threads an SM
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxChannels = 4;
constexpr int kMaxCluster = 8;
constexpr int kGroup = 64;      // output columns of one column group
constexpr int kChunkRows = 32;  // output rows of one staging round: a warp lane each
constexpr unsigned kFull = 0xffffffffu;

struct ColEntry {
  int off0, off1;  // source byte offsets x0 * C, x1 * C in a row
  float wx, wx1;
};

struct RowEntry {
  int base0, base1;  // stage index of byte 0 of the rows y0 and y1
  float wy, wy1;
};

struct Letterbox {
  float lo_x, lo_y, size_x, size_y, scale_x, scale_y;
  int new_h, new_w, ph, pw, last_x, last_y;
  bool valid;
};

// the head of the dynamic shared memory; the stage and the band follow it
struct alignas(16) Shared {
  Letterbox lb;
  ColEntry cols[kGroup];
  RowEntry rows[kChunkRows];
  const uint8_t* slot_src[2 * kChunkRows];  // 16-byte-aligned source of each staged row
  int slot_units[2 * kChunkRows];           // its 16-byte copies
  int part[kMaxWarps][kMaxChannels];        // per-warp sums
  int peer_sums[kMaxCluster][kMaxChannels]; // each cluster block's sums, written by it
  int group, chunk_rows, slots, stride;     // the current round, from warp 0
  int half_rows, half_slots;                // its first half: rows, and the slots they read
};

// --- device primitives ---------------------------------------------------------
__device__ __forceinline__ uint8_t* dynamic_smem() {
  extern __shared__ __align__(16) uint8_t smem[];
  return smem;
}
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(__cvta_generic_to_global(src))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_newest_pending() {  // all but the newest group landed
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
__device__ __forceinline__ int cluster_size() { return static_cast<int>(cg::this_cluster().num_blocks()); }
__device__ __forceinline__ int cluster_rank() { return static_cast<int>(cg::this_cluster().block_rank()); }
__device__ __forceinline__ int cluster_id() {
  unsigned id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(id));
  return static_cast<int>(id);
}
// arrive early, wait late: a peer's shared memory may be written once every
// block of the cluster has arrived (has started)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }
// release the writes to peers, acquire theirs
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ int* cluster_peer(int* p, int rank) { return cg::this_cluster().map_shared_rank(p, rank); }
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// -------------------------------------------------------------------------------

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// Optional timestamps (ns, %globaltimer) per block: start, box read and
// letterbox worked out, the first round's rows numbered, the first round
// staged, every round blended, the pad colour exchanged, the band stored.
constexpr int kPhases = 7;

__device__ __forceinline__ void stamp(unsigned long long* stamps, int phase) {
  if (stamps != nullptr && threadIdx.x == 0) stamps[static_cast<int64_t>(blockIdx.x) * kPhases + phase] = globaltimer();
}

// bytes of shared memory a staged row of `span` source bytes takes: the
// span widened to 16-byte alignment at both ends, for any alignment
__host__ __device__ __forceinline__ int span_stride(int span) { return (span + 30) / 16 * 16; }

// A byte's float, and a float in (-2^22, 2^22) rounded half to even to an
// int, with integer and fp32 operations (the conversion unit issues a
// quarter as fast): 2^23 + b is exact, and adding 1.5 * 2^23 leaves the
// rounded value in the low mantissa bits.
__device__ __forceinline__ float byte_to_float(uint32_t b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | b), 8388608.0f);
}
__device__ __forceinline__ int round_to_int(float s) { return __float_as_int(__fadd_rn(s, 12582912.0f)) - 0x4B400000; }

__device__ __forceinline__ Letterbox letterbox(const int* __restrict__ box, int H, int W, int th, int tw) {
  const int bx0 = __ldg(box + 0), by0 = __ldg(box + 1), bx1 = __ldg(box + 2), by1 = __ldg(box + 3);
  Letterbox b;
  b.lo_x = static_cast<float>(bx0);
  b.lo_y = static_cast<float>(by0);
  const float cw = __fsub_rn(static_cast<float>(bx1), b.lo_x);
  const float ch = __fsub_rn(static_cast<float>(by1), b.lo_y);
  b.valid = cw > 0.0f && ch > 0.0f;
  b.size_x = fmaxf(cw, 1.0f);
  b.size_y = fmaxf(ch, 1.0f);
  const int cwi = max(bx1 - bx0, 1), chi = max(by1 - by0, 1);
  const bool wide = cwi * th > chi * tw;
  b.new_w = max(wide ? tw : (th * cwi) / chi, 1);
  b.new_h = max(wide ? (tw * chi) / cwi : th, 1);
  b.ph = (th - b.new_h) / 2;
  b.pw = (tw - b.new_w) / 2;
  b.scale_y = __fdiv_rn(b.size_y, static_cast<float>(b.new_h));
  b.scale_x = __fdiv_rn(b.size_x, static_cast<float>(b.new_w));
  b.last_y = min(static_cast<int>(__fadd_rn(b.lo_y, b.size_y)) - 1, H - 1);
  b.last_x = min(static_cast<int>(__fadd_rn(b.lo_x, b.size_x)) - 1, W - 1);
  return b;
}

// cv2 INTER_LINEAR's source of letterboxed index r along one axis: the two
// neighbours (clamped at the crop's last index, then into the frame, as
// XLA's gather clamps) and the weight of the second
__device__ __forceinline__ void source_index(int r, float scale, float lo, float size, int extent, int last,
                                             int& i0, int& i1, float& w) {
  const float s = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(r), 0.5f), scale), 0.5f);
  const float src = fminf(fmaxf(__fadd_rn(fminf(fmaxf(s, 0.0f), __fsub_rn(size, 1.0f)), lo), 0.0f),
                          static_cast<float>(extent - 1));
  const int f = static_cast<int>(floorf(src));
  w = __fsub_rn(src, static_cast<float>(f));
  i0 = clampi(f, 0, extent - 1);
  i1 = clampi(min(f + 1, last), 0, extent - 1);
}

template <bool kNormalize>
__device__ __forceinline__ int store_phase(void* out, int64_t e0) {
  if (kNormalize) return static_cast<int>((reinterpret_cast<uintptr_t>(static_cast<float*>(out) + e0) >> 2) & 3);
  return static_cast<int>(reinterpret_cast<uintptr_t>(static_cast<uint8_t*>(out) + e0) & 15);
}

// The band's `count` output elements from element e0 on: element k is the
// byte band[phase + k] (or 0 for a blank frame), as uint8 or float32 / 255.
// Units of 16 bytes aligned in the output; the partial units at the ends
// element by element.
template <bool kNormalize>
__device__ __forceinline__ void store_band(void* out, int64_t e0, int count, const uint8_t* band, int phase,
                                           bool blank) {
  constexpr int kVec = kNormalize ? 4 : 16;  // elements of a 16-byte store
  constexpr float kInv255 = 1.0f / 255.0f;
  const int units = (phase + count + kVec - 1) / kVec;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int k0 = u * kVec - phase;
    if (k0 >= 0 && k0 + kVec <= count) {
      if (kNormalize) {
        const uint32_t w = blank ? 0u : *reinterpret_cast<const uint32_t*>(band + u * kVec);
        const float4 v = make_float4(__fmul_rn(byte_to_float(w & 255u), kInv255),
                                     __fmul_rn(byte_to_float((w >> 8) & 255u), kInv255),
                                     __fmul_rn(byte_to_float((w >> 16) & 255u), kInv255),
                                     __fmul_rn(byte_to_float(w >> 24), kInv255));
        *reinterpret_cast<float4*>(static_cast<float*>(out) + e0 + k0) = v;
      } else {
        const uint4 v = blank ? make_uint4(0u, 0u, 0u, 0u) : *reinterpret_cast<const uint4*>(band + u * kVec);
        *reinterpret_cast<uint4*>(static_cast<uint8_t*>(out) + e0 + k0) = v;
      }
    } else {
      for (int b = 0; b < kVec; ++b) {
        const int k = k0 + b;
        if (k < 0 || k >= count) continue;
        const int v = blank ? 0 : band[phase + k];
        if (kNormalize) {
          static_cast<float*>(out)[e0 + k] = __fmul_rn(byte_to_float(v), kInv255);
        } else {
          static_cast<uint8_t*>(out)[e0 + k] = static_cast<uint8_t>(v);
        }
      }
    }
  }
}

// One block per band of a frame, a cluster of K blocks per frame (the grid
// runs over frames x K). C is a template parameter where it is 1 or 3, and
// `channels` otherwise (kC = 0).
template <int kC, bool kNormalize>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
crop_resize_pad_kernel(const uint8_t* __restrict__ frames, const int* __restrict__ boxes, void* __restrict__ out,
                       int H, int W, int channels, int th, int tw, int stage_bytes,
                       unsigned long long* __restrict__ stamps) {
  stamp(stamps, 0);
  const int C = kC > 0 ? kC : channels;
  Shared& sh = *reinterpret_cast<Shared*>(dynamic_smem());
  uint8_t* stage = dynamic_smem() + sizeof(Shared);
  uint8_t* band = stage + stage_bytes;
  const int K = cluster_size(), rank = cluster_rank();
  const int64_t n = cluster_id();
  const int tid = threadIdx.x, T = blockDim.x, warp = tid >> 5, lane = tid & 31;
  // warp 0 reads the box and works out the letterbox for the block
  if (warp == 0) {
    const Letterbox lb = letterbox(boxes + 4 * n, H, W, th, tw);
    if (lane == 0) sh.lb = lb;
  }
  __syncthreads();
  const Letterbox lb = sh.lb;
  stamp(stamps, 1);

  // this block's band of output rows [r0, r1), and where it lands
  const int R = (th + K - 1) / K;
  const int r0 = min(rank * R, th), r1 = min(r0 + R, th);
  const int row_elems = tw * C, count = (r1 - r0) * row_elems;
  const int64_t e0 = (n * th + r0) * static_cast<int64_t>(row_elems);
  const int phase = store_phase<kNormalize>(out, e0);
  if (!lb.valid) {  // the whole cluster takes this branch: no peer is touched
    store_band<kNormalize>(out, e0, count, band, phase, true);
    stamp(stamps, kPhases - 1);
    return;
  }
  cluster_arrive_relaxed();

  const uint8_t* frame = frames + n * H * static_cast<int64_t>(W) * C;
  const int64_t row_bytes = static_cast<int64_t>(W) * C;
  const int lo = max(r0, lb.ph) - lb.ph, hi = min(r1, lb.ph + lb.new_h) - lb.ph;  // letterboxed rows of the band
  const int max_stride = stage_bytes / min(2, H) / 16 * 16;
  int local[kMaxChannels] = {0, 0, 0, 0};
  auto copy_slot = [&](int s, int st) {  // a staged row, the warp's lanes over its 16-byte units
    const uint8_t* src = sh.slot_src[s];
    uint8_t* dst = stage + s * st;
    const int units = sh.slot_units[s];
    for (int u = lane; u < units; u += 32) cp_async_16(dst + 16 * u, src + 16 * u);
  };
  for (int j0 = 0, g = 0; lo < hi && j0 < lb.new_w; j0 += g) {
    // the group's column entries, from the last warps (warp 0 numbers the rows)
    const int gmax = min(kGroup, lb.new_w - j0);
    for (int t = T - 1 - tid; t < gmax; t += T) {
      int x0, x1;
      float wx;
      source_index(j0 + t, lb.scale_x, lb.lo_x, lb.size_x, W, lb.last_x, x0, x1, wx);
      sh.cols[t] = {x0 * C, x1 * C, wx, __fsub_rn(1.0f, wx)};
    }
    // warp 0: the column group [j0, j0 + g) whose span fits two staged rows
    int xa = 0, span = 0, stride = 0;
    if (warp == 0) {
      int x0, x1;
      float w;
      source_index(j0, lb.scale_x, lb.lo_x, lb.size_x, W, lb.last_x, x0, x1, w);
      xa = x0 * C;
      source_index(j0 + gmax - 1, lb.scale_x, lb.lo_x, lb.size_x, W, lb.last_x, x0, x1, w);
      span = x1 * C + C - xa;
      g = gmax;
      if (span_stride(span) > max_stride) {  // wide: the longest prefix that fits
        g = 0;
        for (int k = 0; k < gmax; k += 32) {
          bool fits = false;
          if (k + lane < gmax) {
            source_index(j0 + k + lane, lb.scale_x, lb.lo_x, lb.size_x, W, lb.last_x, x0, x1, w);
            fits = span_stride(x1 * C + C - xa) <= max_stride;
          }
          const unsigned ballot = __ballot_sync(kFull, fits);
          g += __popc(ballot);
          if (ballot != kFull) break;
        }
        source_index(j0 + g - 1, lb.scale_x, lb.lo_x, lb.size_x, W, lb.last_x, x0, x1, w);
        span = x1 * C + C - xa;
      }
      stride = span_stride(span);
    }
    for (int i0 = lo; i0 < hi;) {
      if (warp == 0) {
        // lane i: letterboxed row i0 + i, its rows y0 <= y1 <= y0 + 1, numbered
        // among the round's distinct rows (both sequences non-decreasing)
        const int i = i0 + lane;
        const bool live = i < hi;
        int y0 = 0, y1 = 0;
        float wy = 0.0f;
        if (live) source_index(i, lb.scale_y, lb.lo_y, lb.size_y, H, lb.last_y, y0, y1, wy);
        int prev = __shfl_up_sync(kFull, y1, 1);
        if (lane == 0) prev = -1;
        const bool new0 = live && y0 > prev, new1 = live && y1 > y0 && y1 > prev;
        const unsigned m0 = __ballot_sync(kFull, new0), m1 = __ballot_sync(kFull, new1);
        const unsigned upto = kFull >> (31 - lane);
        const int incl = __popc(m0 & upto) + __popc(m1 & upto), excl = incl - new0 - new1;
        const int m = __popc(__ballot_sync(kFull, live && incl <= stage_bytes / stride));
        if (lane < m) {
          const int sa = new0 ? excl : excl - 1 - (prev - y0);
          const int sb = y1 == y0 ? sa : (new1 ? excl + new0 : excl - 1);
          const uint8_t* row_a = frame + y0 * row_bytes + xa;
          const uint8_t* row_b = frame + y1 * row_bytes + xa;
          const int shift_a = static_cast<int>(reinterpret_cast<uintptr_t>(row_a) & 15);
          const int shift_b = static_cast<int>(reinterpret_cast<uintptr_t>(row_b) & 15);
          sh.rows[lane] = {sa * stride + shift_a - xa, sb * stride + shift_b - xa, wy, __fsub_rn(1.0f, wy)};
          if (new0) {
            sh.slot_src[sa] = row_a - shift_a;
            sh.slot_units[sa] = (shift_a + span + 15) / 16;
          }
          if (new1) {
            sh.slot_src[sb] = row_b - shift_b;
            sh.slot_units[sb] = (shift_b + span + 15) / 16;
          }
        }
        if (lane == 0) {
          const unsigned first = m == 32 ? kFull : (1u << m) - 1u;  // the round's lanes
          const unsigned halfway = (1u << ((m + 1) / 2)) - 1u;       // its first half
          sh.group = g;
          sh.chunk_rows = m;
          sh.slots = __popc(m0 & first) + __popc(m1 & first);
          sh.half_rows = (m + 1) / 2;
          sh.half_slots = __popc(m0 & halfway) + __popc(m1 & halfway);
          sh.stride = stride;
        }
      }
      __syncthreads();
      if (i0 == lo && j0 == 0) stamp(stamps, 2);
      g = sh.group;
      const int m = sh.chunk_rows, slots = sh.slots, st = sh.stride, half = sh.half_rows, s1 = sh.half_slots;
      // the round's rows x span into the stage, every copy in flight at once,
      // in two groups: the slots of the first half of the rows, then the rest
      for (int s = warp; s < s1; s += T >> 5) copy_slot(s, st);
      cp_async_commit();
      for (int s = s1 + warp; s < slots; s += T >> 5) copy_slot(s, st);
      cp_async_commit();
      // blend rows [ra, rb) of the round (x g columns) from the stage into the band
      const int di = T / g, dj = T - (T / g) * g;
      auto blend = [&](int ra, int rb) {
        int i = ra + tid / g, j = tid - (tid / g) * g;
        while (i < rb) {
          const RowEntry re = sh.rows[i];
          const ColEntry ce = sh.cols[j];
          // every byte loaded before any is stored (the band and the stage
          // are both shared memory), the channels' blends side by side
          float p[kMaxChannels][4];
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c) {
            if (c >= C) break;
            p[c][0] = byte_to_float(stage[re.base0 + ce.off0 + c]);
            p[c][1] = byte_to_float(stage[re.base0 + ce.off1 + c]);
            p[c][2] = byte_to_float(stage[re.base1 + ce.off0 + c]);
            p[c][3] = byte_to_float(stage[re.base1 + ce.off1 + c]);
          }
          uint8_t* dst = band + phase + (lb.ph + i0 + i - r0) * row_elems + (lb.pw + j0 + j) * C;
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c) {
            if (c >= C) break;
            // (((p00*(1-wy))*(1-wx) + (p01*(1-wy))*wx) + (p10*wy)*(1-wx)) + (p11*wy)*wx
            float s = __fmul_rn(__fmul_rn(p[c][0], re.wy1), ce.wx1);
            s = __fadd_rn(s, __fmul_rn(__fmul_rn(p[c][1], re.wy1), ce.wx));
            s = __fadd_rn(s, __fmul_rn(__fmul_rn(p[c][2], re.wy), ce.wx1));
            s = __fadd_rn(s, __fmul_rn(__fmul_rn(p[c][3], re.wy), ce.wx));
            const int v = min(max(round_to_int(s), 0), 255);
            dst[c] = static_cast<uint8_t>(v);
            local[c] += v;
          }
          i += di;
          j += dj;
          if (j >= g) {
            j -= g;
            ++i;
          }
        }
      };
      cp_async_wait_newest_pending();
      __syncthreads();
      if (i0 == lo && j0 == 0) stamp(stamps, 3);
      blend(0, half);  // while the second group lands
      cp_async_wait_all();
      __syncthreads();
      blend(half, m);
      i0 += m;
      __syncthreads();  // the blend is done with the entries and the stage
    }
  }

  stamp(stamps, 4);
  // the band's sums, then the frame's through the cluster's shared memory
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    const int v = __reduce_add_sync(kFull, local[c]);
    if (lane == 0) sh.part[warp][c] = v;
  }
  __syncthreads();
  cluster_wait();
  if (tid < K * C) {
    const int q = tid / C, c = tid - (tid / C) * C;
    int s = 0;
    for (int w = 0; w < T >> 5; ++w) s += sh.part[w][c];
    cluster_peer(&sh.peer_sums[0][0], q)[rank * kMaxChannels + c] = s;
  }
  cluster_sync();
  stamp(stamps, 5);
  uint8_t pad[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    int total = 0;
    for (int q = 0; q < K; ++q) total += sh.peer_sums[q][c];
    pad[c] = c < C ? static_cast<uint8_t>(static_cast<int>(
                         floorf(__fdiv_rn(static_cast<float>(total), static_cast<float>(lb.new_h * lb.new_w)))))
                   : 0;
  }
  // the pad colour into the band's pixels outside the letterbox
  {
    int i = tid / tw, j = tid - (tid / tw) * tw;
    const int di = T / tw, dj = T - (T / tw) * tw;
    while (i < r1 - r0) {
      const int r = r0 + i;
      if (r < lb.ph || r >= lb.ph + lb.new_h || j < lb.pw || j >= lb.pw + lb.new_w) {
        uint8_t* dst = band + phase + i * row_elems + j * C;
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c) {
          if (c >= C) break;
          dst[c] = pad[c];
        }
      }
      i += di;
      j += dj;
      if (j >= tw) {
        j -= tw;
        ++i;
      }
    }
  }
  __syncthreads();
  store_band<kNormalize>(out, e0, count, band, phase, false);
  stamp(stamps, kPhases - 1);
}

template <int kC>
const void* kernel_for(int normalize) {
  return normalize ? reinterpret_cast<const void*>(crop_resize_pad_kernel<kC, true>)
                   : reinterpret_cast<const void*>(crop_resize_pad_kernel<kC, false>);
}

const void* kernel_for(int C, int normalize) {
  return C == 3 ? kernel_for<3>(normalize) : (C == 1 ? kernel_for<1>(normalize) : kernel_for<0>(normalize));
}

// the band of one block and its alignment slack, after the stage
size_t dynamic_smem(int th, int tw, int C, int cluster, int stage_bytes) {
  const size_t band = static_cast<size_t>((th + cluster - 1) / cluster) * tw * C;
  return sizeof(Shared) + static_cast<size_t>(stage_bytes) + (band + 16 + 15) / 16 * 16;
}

bool valid_launch(int H, int W, int C, int th, int tw, int cluster, int threads, int stage_bytes) {
  return H > 0 && W > 0 && C > 0 && C <= kMaxChannels && th > 0 && tw > 0 &&
         static_cast<long long>(th) * tw * C <= 48 * 1024 && cluster >= 1 && cluster <= kMaxCluster &&
         threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 && stage_bytes >= 64 &&
         stage_bytes % 16 == 0 && dynamic_smem(th, tw, C, cluster, stage_bytes) <= 227 * 1024;
}

cudaLaunchConfig_t launch_shape(long long n, int th, int tw, int C, int cluster, int threads, int stage_bytes,
                                cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n * cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = dynamic_smem(th, tw, C, cluster, stage_bytes);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

}  // namespace

// frames (n, H, W, C) uint8, boxes (n, 4) int32, out (n, th, tw, C) uint8 or
// float32 (normalize); all contiguous on the device. A cluster of `cluster`
// blocks of `threads` threads per frame, `stage_bytes` of shared memory for
// the staged source rows of a round; `stamps` (n * cluster * 7 int64, or
// null) takes each block's phase timestamps. Returns the launch's CUDA
// error (0 = success).
extern "C" int mlt_crop_resize_pad(const void* frames, const void* boxes, void* out, long long n, int H, int W,
                                   int C, int th, int tw, int normalize, int cluster, int threads, int stage_bytes,
                                   void* stamps, void* stream) {
  if (n <= 0 || n * cluster > 2147483647LL || !valid_launch(H, W, C, th, tw, cluster, threads, stage_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_for(C, normalize);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      launch_shape(n, th, tw, C, cluster, threads, stage_bytes, static_cast<cudaStream_t>(stream), &attr);
  cudaError_t err = allow_smem(fn, cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  const int* b = static_cast<const int*>(boxes);
  unsigned long long* st = static_cast<unsigned long long*>(stamps);
  void* args[] = {&f, &b, &out, &H, &W, &C, &th, &tw, &stage_bytes, &st};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The launch for frames of (H, W, C) at target (th, tw), into info[0..9):
// threads per block, blocks per cluster, stage bytes, dynamic shared memory
// bytes, static shared memory bytes, registers per thread, local (spill)
// bytes per thread, blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// and clusters resident on the card at once (cudaOccupancyMaxActiveClusters).
// Returns the first CUDA error (0 = success).
extern "C" int mlt_crop_resize_pad_launch_config(int H, int W, int C, int th, int tw, int normalize, int cluster,
                                                 int threads, int stage_bytes, int* info) {
  if (!valid_launch(H, W, C, th, tw, cluster, threads, stage_bytes)) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_for(C, normalize);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_shape(1, th, tw, C, cluster, threads, stage_bytes, nullptr, &attr);
  cudaFuncAttributes fa;
  cudaError_t err = allow_smem(fn, cfg.dynamicSmemBytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fn);
  int per_sm = 0, clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, cfg.dynamicSmemBytes);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int values[9] = {threads, cluster, stage_bytes, static_cast<int>(cfg.dynamicSmemBytes),
                         static_cast<int>(fa.sharedSizeBytes), fa.numRegs, static_cast<int>(fa.localSizeBytes),
                         per_sm, clusters};
  for (int i = 0; i < 9; ++i) info[i] = values[i];
  return 0;
}
