// Greedy class-aware NMS for Hopper, in three variants.
//
// Replaces the TPU kernel yoloret_tpu/ops/nms_pallas.py::_nms_kernel
// (nms_fused) and, on the serving path, the XLA loop
// yoloret_tpu/ops/postprocess.py::_suppress_lax_shared. Python side, with
// the launch plan: ops/nms_kernel.py.
//
// Per (image, class), max_det rounds: take the highest active score
// (ties to the lowest candidate index), emit it with its box, deactivate
// the pick and every candidate whose IoU with it is strictly above the
// threshold. Scores below the score threshold start inactive; empty
// slots get a zero box and the caller's empty score (0, or -inf where
// the caller tells picks from empty slots by it). Built with -fmad=false,
// so every IoU rounds exactly as the plain PyTorch version's does.
//
// nms_shared: the shared pool (boxes [B, M, 4], class stride 0), which is
// the serving path. One CTA per image.
//   What bounds it: the IoUs. Greedy NMS per class needs the IoU of each
//   pick against every candidate, and with one box set per image the C
//   classes ask for the same IoUs again and again. Built once per image,
//   the mask's M^2 / 2 IoUs (min, max and compares, which run at half
//   rate) set the time at M=512; at M=64 the rounds do, a chain of
//   dependent steps whose latency, not throughput, counts. Bytes (the
//   image's scores and boxes, read once) are a few microseconds for the
//   whole batch.
//   Design: the image's boxes and [C, M] scores come into shared memory
//   by cp.async (the scores land while phase 1 runs). Phase 1: all warps
//   build the suppression mask kill[i][j] = iou(i, j) > thr once per
//   image, M x M bits, row i as M contiguous bits. A warp takes half of a
//   32 x 32 tile (I <= J) of the upper triangle, 16 rows (half tiles
//   spread the items evenly over the warps); lane l holds box 32J + l,
//   the rows are broadcast from shared memory, and each pair is computed
//   once: the lane's 16 bits are half of the word of row 32J + l in the
//   mirror tile (the IoU is bitwise symmetric: min, max and area_i +
//   area_j commute), and a bit transpose across the warp (5 shuffles)
//   gives the words of the 16 rows. The division is skipped where inter
//   against thr * (1 +- 2^-18) * uni settles the comparison beyond
//   rounding; inside that margin (a warp-uniform branch, rarely taken)
//   the IoU is divided exactly as the plain version does. The diagonal is
//   set, so a pick also kills itself. Phase 2: one warp per class
//   (classes looped when C exceeds the warps), candidates lane * NPL ..
//   lane * NPL + NPL - 1 in registers as order-preserving integer keys.
//   A round is an in-lane max tree, a warp reduction (__reduce_max_sync)
//   and a ballot for the lowest lane holding the top key (ties to the
//   lowest index), and the kill: one 32-bit shared load of the pick's
//   mask row per lane and a bit test per candidate -- no IoU and no
//   division inside a round. Picks are collected in shared memory and
//   each class's outputs are written as contiguous runs at the end. When
//   [C, M] scores do not fit beside the mask, they come in passes of
//   `cs` classes.
//
// nms_kernel: per-class pools (boxes [B, C, K, 4], the TPU kernel's own
// contract; not on the serving path; a mask per class would not fit in
// shared memory). One warp per (image, class).
//   What bounds it: the loop's operations (rounds x candidates x one
//   IoU); its inputs are read once. Design: candidates strided over the
//   32 lanes and held in registers for all rounds (scores, four
//   coordinates, area); a round is a lane-local scan, a 5-step shuffle
//   argmax over (score, -index), a shuffle broadcast of the pick's box and
//   one IoU per candidate -- no shared memory, no barrier, no memory
//   traffic inside the loop. A warp stops at the first round with nothing
//   left to pick. Up to 512 candidates (16 a lane).
//
// nms_large: pools of any size above that (per-class pools, K up to
// ~58k; a shared pool is the same with class stride 0). The exact-NMS
// evaluation runs it with the whole grid as each class's pool (6,300
// candidates at 320x320, 10,647 at 416x416), every pool sorted by score
// (ops/postprocess.py::per_class_candidates).
//   What bounds it: bytes. Every score must be read once to know the
//   pool's order; on a pool whose keys do not increase, greedy's next
//   pick is the first active candidate in index order, so once the D-th
//   pick is made no later candidate can change the output, and only the
//   boxes up to the last pick are needed. On an unsorted pool, the
//   rounds' operations (one IoU per active candidate per round).
//   Design: two kernels, launched back to back.
//   nms_large_walk, one CTA of WALK_WARPS warps per (image, class): the
//   class's scores are read once, coalesced (WALK_UNROLL 16-byte loads in
//   flight a thread, from the first 16-byte aligned score), as
//   order-preserving keys (0 = inactive); the pool is sorted when no key
//   is below its successor (a group's last key against the next lane's
//   first by a shuffle; the warp's last lane reads its successor again),
//   one block-wide AND. The first chunk's boxes are fetched meanwhile.
//   Sorted (the main path): warp 0 walks the candidates in index order,
//   32 at a time, one lane each. A chunk loads its own boxes only; each
//   lane tests its candidate against the picks so far (at most D, in
//   shared memory); the chunk's own greedy order is resolved lane by lane
//   (ballot of the survivors, the lowest is picked, its box broadcast by
//   shuffles, the later lanes test it). The walk stops at the D-th pick
//   or at the first inactive key (every later key is inactive too):
//   boxes after that are never read. Unsorted: the CTA flags the pool and
//   ends.
//   nms_large_rounds, persistent (as many CTAs as fit on the card, one
//   pool after another): each flagged pool gets the greedy rounds. Its
//   keys, and where K x 20 B fit in shared memory also its boxes, are
//   staged in shared memory for all rounds (above that size the boxes
//   are read from device memory each round). Candidate k belongs to
//   thread k mod T, which alone reads and writes its key. A round is a
//   strided scan for the thread's top key (ascending index, strict >:
//   ties to the lowest index), a warp reduction (__reduce_max_sync on the
//   key, __reduce_min_sync on the index), the warp winners into one of
//   two buffers, one barrier, every warp's own reduction of the winners
//   (the buffers alternate, so the next round's writes cannot meet this
//   round's reads), and one IoU per active candidate against the pick.
//   Both kernels skip the division where inter against thr * (1 +- 2^-18)
//   * union settles the comparison (a union of at least MIN_AREA keeps
//   those products normal) and divide exactly as the plain version does
//   elsewhere.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // warps per block of the per-class kernel
constexpr int MAX_NPL = 16;
constexpr int MAX_SHARED_WARPS = 32;
// The variants, in the numbering of ops/nms_kernel.py::VARIANTS.
constexpr int VARIANT_PER_CLASS = 0, VARIANT_SHARED = 1, VARIANT_LARGE = 2;
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory one block may use (sm_90)
constexpr unsigned FULL = 0xffffffffu;
// An image with an area in (0, MIN_AREA) has its every pair divided: with
// areas of 0 or at least MIN_AREA, a union is 0 or above MIN_AREA / 2, and
// the margin test's products stay in float32's normal range.
constexpr float MIN_AREA = 0x1p-58f;

template <int NPL>  // candidates per lane
__global__ void __launch_bounds__(WARPS * 32)
    nms_kernel(const float* __restrict__ scores, const float* __restrict__ boxes,
               float* __restrict__ out_boxes, float* __restrict__ out_scores, int B, int C,
               int K, int D, long long box_bstride, long long box_cstride, float iou_thr,
               float score_thr, float empty_score) {
  const int warp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= B * C) return;
  const int b = warp / C, c = warp - b * C;
  const float* sc = scores + size_t(warp) * K;
  const float* bx = boxes + b * box_bstride + c * box_cstride;

  float s[NPL], y0[NPL], x0[NPL], y1[NPL], x1[NPL], ar[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int k = lane + 32 * i;
    s[i] = -INFINITY;
    y0[i] = x0[i] = y1[i] = x1[i] = ar[i] = 0.f;
    if (k < K) {
      const float v = sc[k];
      s[i] = v >= score_thr ? v : -INFINITY;
      y0[i] = bx[4 * k + 0];
      x0[i] = bx[4 * k + 1];
      y1[i] = bx[4 * k + 2];
      x1[i] = bx[4 * k + 3];
      ar[i] = fmaxf(0.f, x1[i] - x0[i]) * fmaxf(0.f, y1[i] - y0[i]);
    }
  }

  float* ob = out_boxes + size_t(warp) * D * 4;
  float* os = out_scores + size_t(warp) * D;
  int r = 0;
  for (; r < D; ++r) {
    float best = -INFINITY;
    int bi = K;
#pragma unroll
    for (int i = 0; i < NPL; ++i)  // ascending index: strict > keeps the lowest
      if (s[i] > best) {
        best = s[i];
        bi = lane + 32 * i;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob_ = __shfl_xor_sync(FULL, best, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (ob_ > best || (ob_ == best && oi < bi)) {
        best = ob_;
        bi = oi;
      }
    }
    if (!(best > -INFINITY)) break;  // nothing active is left

    const int owner = bi & 31, slot = bi >> 5;
    float py0 = 0.f, px0 = 0.f, py1 = 0.f, px1 = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i)
      if (i == slot) {
        py0 = y0[i];
        px0 = x0[i];
        py1 = y1[i];
        px1 = x1[i];
      }
    py0 = __shfl_sync(FULL, py0, owner);
    px0 = __shfl_sync(FULL, px0, owner);
    py1 = __shfl_sync(FULL, py1, owner);
    px1 = __shfl_sync(FULL, px1, owner);
    if (lane == 0) {
      os[r] = best;
      ob[4 * r + 0] = py0;
      ob[4 * r + 1] = px0;
      ob[4 * r + 2] = py1;
      ob[4 * r + 3] = px1;
    }
    const float pa = fmaxf(0.f, px1 - px0) * fmaxf(0.f, py1 - py0);
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const float iy = fmaxf(0.f, fminf(py1, y1[i]) - fmaxf(py0, y0[i]));
      const float ix = fmaxf(0.f, fminf(px1, x1[i]) - fmaxf(px0, x0[i]));
      const float inter = ix * iy;
      const float uni = pa + ar[i] - inter;
      const float iou = uni != 0.f ? inter / uni : 0.f;
      if (iou > iou_thr || lane + 32 * i == bi) s[i] = -INFINITY;
    }
  }
  for (int t = r + lane; t < D; t += 32) {
    os[t] = empty_score;
    ob[4 * t + 0] = ob[4 * t + 1] = ob[4 * t + 2] = ob[4 * t + 3] = 0.f;
  }
}

// ---- shared-pool kernel ------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n floats from global src to shared dst, spread over the block's threads:
// 16-byte copies when both ends are 16-byte aligned, else 4-byte ones.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) cp_async16(dst + 4 * i, src + 4 * i);
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i);
}

// inter and union of boxes p and q, rounded as the plain version rounds
// them (boxes are (ymin, xmin, ymax, xmax) in x, y, z, w). Symmetric in
// p and q: min, max and pa + qa commute.
__device__ __forceinline__ void pair_terms(float4 p, float pa, float4 q, float qa, float& inter,
                                           float& uni) {
  const float iy = fmaxf(0.f, fminf(p.z, q.z) - fmaxf(p.x, q.x));
  const float ix = fmaxf(0.f, fminf(p.w, q.w) - fmaxf(p.y, q.y));
  inter = ix * iy;
  uni = pa + qa - inter;
}

// Lane l's bit b goes to lane b's bit l (a 32 x 32 bit matrix across the
// warp, transposed by swapping off-diagonal blocks of 16, 8, 4, 2, 1).
__device__ __forceinline__ uint32_t transpose_bits(uint32_t v, int lane) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const uint32_t m = s == 16 ? 0x0000ffffu
                       : s == 8 ? 0x00ff00ffu
                       : s == 4 ? 0x0f0f0f0fu
                       : s == 2 ? 0x33333333u
                                : 0x55555555u;
    const uint32_t x = __shfl_xor_sync(FULL, v, s);
    v = (lane & s) ? ((v & ~m) | ((x >> s) & m)) : ((v & m) | ((x & m) << s));
  }
  return v;
}

// A float's order as an unsigned key (-0 and +0 equal); 0 stands for an
// inactive candidate, below every float's key.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v == 0.f ? 0.f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int NPL>
__global__ void __launch_bounds__(MAX_SHARED_WARPS * 32)
    nms_shared(const float* __restrict__ scores, const float* __restrict__ boxes,
               float* __restrict__ out_boxes, float* __restrict__ out_scores, int C, int M,
               int D, long long box_bstride, int cs, float iou_thr, float thr_lo, float thr_hi,
               float score_thr, float empty_score) {
  constexpr int MP = 32 * NPL;  // candidates padded to the lanes' slots
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);                  // [MP]
  uint32_t* smask = reinterpret_cast<uint32_t*>(sbox + MP);        // [MP][NPL]
  float* sarea = reinterpret_cast<float*>(smask + MP * NPL);       // [MP]
  float* ssc = sarea + MP;                                         // [cs][M]
  int* spick = reinterpret_cast<int*>(ssc + ((cs * M + 3) & ~3));  // [min(W, cs)][D]

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const float* gsc = scores + size_t(b) * C * M;

  copy_async(reinterpret_cast<float*>(sbox), boxes + b * box_bstride, 4 * M);
  cp_async_commit();
  copy_async(ssc, gsc, min(cs, C) * M);
  cp_async_commit();
  for (int i = M + tid; i < MP; i += blockDim.x) sbox[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  cp_async_wait<1>();  // this thread's box copies have landed
  __syncthreads();
  bool tiny = false;
  for (int i = tid; i < MP; i += blockDim.x) {
    const float4 v = sbox[i];
    sarea[i] = fmaxf(0.f, v.w - v.y) * fmaxf(0.f, v.z - v.x);
    tiny |= sarea[i] > 0.f && sarea[i] < MIN_AREA;
  }
  if (__syncthreads_or(tiny)) {  // settle nothing by the margin: divide every pair
    thr_lo = -INFINITY;
    thr_hi = INFINITY;
  }

  // Phase 1: the mask. A work item is half a 32 x 32 tile (I <= J): 16
  // rows 32I + 16h + r against the 32 columns 32J + lane.
  const int nt = (M + 31) >> 5;
  const int items = nt * (nt + 1);
  for (int t = warp; t < items; t += nwarps) {
    const int h = t & 1;
    int I = 0, rem = t >> 1;
    while (rem >= nt - I) {
      rem -= nt - I;
      ++I;
    }
    const int J = I + rem, i0 = 32 * I + 16 * h;
    const float4 bj = sbox[32 * J + lane];
    const float aj = sarea[32 * J + lane];
    // inter > thr_hi * uni puts inter / uni above thr by more than its
    // rounding can undo, inter < thr_lo * uni below it. Pairs that this
    // does not settle (the margin, NaN, a zero union; every pair when the
    // bounds are infinite) are divided afterwards, in a branch the warp
    // takes only when one of its lanes needs it.
    uint32_t bits = 0, open = 0;  // bit r: kill(i0 + r, 32J + lane) / not settled
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float inter, uni;
      pair_terms(sbox[i0 + r], sarea[i0 + r], bj, aj, inter, uni);
      const bool k = inter > thr_hi * uni;
      if (k) bits |= 1u << r;
      if (!k && !(inter < thr_lo * uni)) open |= 1u << r;
    }
    if (__any_sync(FULL, open != 0)) {
      for (int r = 0; r < 16; ++r)
        if ((open >> r) & 1u) {
          float inter, uni;
          pair_terms(sbox[i0 + r], sarea[i0 + r], bj, aj, inter, uni);
          const bool k = (uni != 0.f ? inter / uni : 0.f) > iou_thr;
          bits = (bits & ~(1u << r)) | (uint32_t(k) << r);
        }
    }
    // lane r < 16 gets row i0 + r, word J (bit l = lane l's bit r) by
    // transposing the warp's bits; the diagonal (a pick kills itself) is
    // set here
    uint32_t direct = transpose_bits(bits, lane);
    if (lane < 16) {
      if (I == J) direct |= 1u << (16 * h + lane);
      smask[(i0 + lane) * NPL + J] = direct;
    }
    if (I != J)  // the mirror tile: row 32J + lane, word I, half h
      reinterpret_cast<uint16_t*>(smask + (32 * J + lane) * NPL + I)[h] = uint16_t(bits);
  }
  cp_async_wait<0>();
  __syncthreads();

  // Phase 2: the greedy rounds, one warp per class.
  const int word = (lane * NPL) >> 5, shift = (lane * NPL) & 31;
  for (int c0 = 0; c0 < C; c0 += cs) {
    const int cn = min(cs, C - c0);
    if (c0 > 0) {  // the next pass of classes
      __syncthreads();
      copy_async(ssc, gsc + size_t(c0) * M, cn * M);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int cl = warp; cl < cn; cl += nwarps) {
      const float* sc = ssc + cl * M;
      int* pk = spick + warp * D;
      uint32_t key[NPL];
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int k = lane * NPL + i;
        const float v = k < M ? sc[k] : -INFINITY;
        key[i] = (v >= score_thr && v > -INFINITY) ? order_key(v) : 0u;
      }
      int r = 0;
      for (; r < D; ++r) {
        uint32_t kb[NPL];
        int ib[NPL];
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          kb[i] = key[i];
          ib[i] = i;
        }
#pragma unroll
        for (int w = 1; w < NPL; w *= 2)  // the left (lower) index wins ties
#pragma unroll
          for (int i = 0; i + w < NPL; i += 2 * w)
            if (kb[i + w] > kb[i]) {
              kb[i] = kb[i + w];
              ib[i] = ib[i + w];
            }
        const uint32_t top = __reduce_max_sync(FULL, kb[0]);
        if (top == 0u) break;  // nothing active is left
        // lane l holds candidates l * NPL ..: the lowest lane with the top
        // key holds the lowest index
        const int owner = __ffs(__ballot_sync(FULL, kb[0] == top)) - 1;
        const int p = owner * NPL + __shfl_sync(FULL, ib[0], owner);
        const uint32_t row = smask[p * NPL + word] >> shift;
#pragma unroll
        for (int i = 0; i < NPL; ++i)
          if ((row >> i) & 1u) key[i] = 0u;
        if (lane == 0) pk[r] = p;
      }
      __syncwarp();
      const size_t out = (size_t(b) * C + c0 + cl) * D;
      for (int t = lane; t < D; t += 32) out_scores[out + t] = t < r ? sc[pk[t]] : empty_score;
      const float* sb = reinterpret_cast<const float*>(sbox);
      for (int t = lane; t < 4 * D; t += 32)
        out_boxes[out * 4 + t] = (t >> 2) < r ? sb[pk[t >> 2] * 4 + (t & 3)] : 0.f;
      __syncwarp();
    }
  }
}

// ---- large pools -------------------------------------------------------

constexpr int WALK_WARPS = 4;    // warps per CTA of nms_large_walk
constexpr int WALK_UNROLL = 4;   // 16-byte score loads in flight per thread
constexpr int ROUNDS_WARPS = 32;         // nms_large_rounds with its boxes staged
constexpr int ROUNDS_WARPS_GLOBAL = 16;  // and with its boxes in device memory

// Bytes of dynamic shared memory nms_large_rounds lays out for K
// candidates: with its boxes staged, the boxes [K] (float4), the keys [K]
// (16-byte rounded) and two buffers of the warp winners' keys and indices
// [2][ROUNDS_WARPS] each; where that exceeds SMEM_LIMIT, the keys and the
// winners of ROUNDS_WARPS_GLOBAL warps. ops/nms_kernel.py::
// large_smem_bytes computes the same.
long long large_staged_bytes(int K) {
  return 16LL * K + 16 * ((K + 3LL) / 4) + 16 * ROUNDS_WARPS;
}
long long large_smem_bytes(int K) {
  const long long staged = large_staged_bytes(K);
  return staged <= SMEM_LIMIT ? staged : 16 * ((K + 3LL) / 4) + 16 * ROUNDS_WARPS_GLOBAL;
}
// Bytes of dynamic shared memory nms_large_walk lays out: the picks'
// boxes and scores [D] (ops/nms_kernel.py::walk_smem_bytes).
long long walk_smem_bytes(int D) { return 20LL * D; }

__device__ __forceinline__ uint32_t active_key(float v, float score_thr) {
  return (v >= score_thr && v > -INFINITY) ? order_key(v) : 0u;
}

__device__ __forceinline__ float box_area(float4 q) {
  return fmaxf(0.f, q.w - q.y) * fmaxf(0.f, q.z - q.x);
}

// Box k of a pool (16-byte loads where the pool is 16-byte aligned).
__device__ __forceinline__ float4 load_box(const float* __restrict__ bx, int k, bool aligned) {
  if (aligned) return __ldg(reinterpret_cast<const float4*>(bx) + k);
  return make_float4(__ldg(bx + 4 * k), __ldg(bx + 4 * k + 1), __ldg(bx + 4 * k + 2),
                     __ldg(bx + 4 * k + 3));
}

// iou(p, q) > thr as the plain version decides it (p the pick): inter
// against lo/hi * union where that settles it beyond rounding and the
// union keeps the products normal, else the division.
__device__ __forceinline__ bool kills(float4 p, float pa, float4 q, float iou_thr, float lo,
                                      float hi) {
  float inter, uni;
  pair_terms(p, pa, q, box_area(q), inter, uni);
  if (uni >= MIN_AREA) {
    if (inter > hi * uni) return true;
    if (inter < lo * uni) return false;
  }
  return (uni != 0.f ? inter / uni : 0.f) > iou_thr;
}

__global__ void __launch_bounds__(WALK_WARPS * 32)
    nms_large_walk(const float* __restrict__ scores, const float* __restrict__ boxes,
                   float* __restrict__ out_boxes, float* __restrict__ out_scores,
                   int* __restrict__ unsorted, int C, int K, int D, long long box_bstride,
                   long long box_cstride, float iou_thr, float thr_lo, float thr_hi,
                   float score_thr, float empty_score) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* pbox = reinterpret_cast<float4*>(smem);     // [D]
  float* pscore = reinterpret_cast<float*>(pbox + D);  // [D]

  const int bc = blockIdx.x;
  const int b = bc / C, c = bc - b * C;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nthreads = blockDim.x;
  const float* sc = scores + size_t(bc) * K;
  const float* bx = boxes + b * box_bstride + c * box_cstride;

  // Is every key at least its successor's? The scores as a head of h < 4
  // scalars, n4 16-byte groups (group q is thread q mod T's; the successor
  // of its last score is the next lane's first, by a shuffle, or read
  // again) and a tail of scalars.
  const int h = min(K, int((4u - unsigned((reinterpret_cast<uintptr_t>(sc) >> 2) & 3u)) & 3u));
  const int n4 = (K - h) >> 2;
  const float4* body = reinterpret_cast<const float4*>(sc + h);
  const bool aligned = (reinterpret_cast<uintptr_t>(bx) & 15) == 0;
  // warp 0's first chunk of boxes, fetched while the scores arrive
  const float4 first_q = tid < 32 && tid < K ? load_box(bx, tid, aligned)
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
  bool sorted = true;
  if (tid == 0) {
    for (int k = 0; k < h && k + 1 < K; ++k)
      sorted &= active_key(__ldg(sc + k), score_thr) >= active_key(__ldg(sc + k + 1), score_thr);
    for (int k = h + 4 * n4; k + 1 < K; ++k)
      sorted &= active_key(__ldg(sc + k), score_thr) >= active_key(__ldg(sc + k + 1), score_thr);
  }
  for (int base = 0; base < n4; base += WALK_UNROLL * nthreads) {
    float4 v[WALK_UNROLL];
    float nx[WALK_UNROLL];
#pragma unroll
    for (int u = 0; u < WALK_UNROLL; ++u) {
      const int q = base + u * nthreads + tid, e = h + 4 * q + 4;
      v[u] = q < n4 ? __ldg(body + q) : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      nx[u] = (q < n4 && (lane == 31 || q + 1 >= n4) && e < K) ? __ldg(sc + e) : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < WALK_UNROLL; ++u) {
      const int q = base + u * nthreads + tid;
      const uint32_t k0 = active_key(v[u].x, score_thr), k1 = active_key(v[u].y, score_thr);
      const uint32_t k2 = active_key(v[u].z, score_thr), k3 = active_key(v[u].w, score_thr);
      uint32_t next = __shfl_down_sync(FULL, k0, 1);
      if (lane == 31 || q + 1 >= n4) next = active_key(nx[u], score_thr);  // 0 past the end
      if (q < n4) sorted &= k0 >= k1 && k1 >= k2 && k2 >= k3 && k3 >= next;
    }
  }
  sorted = __syncthreads_and(sorted);
  if (tid == 0) unsorted[bc] = sorted ? 0 : 1;
  if (!sorted || tid >= 32) return;  // an unsorted pool is nms_large_rounds's

  // The walk, warp 0: the picks are the first active candidates that no
  // earlier pick kills.
  int np = 0;
  for (int base = 0; base < K && np < D; base += 32) {
    const int k = base + lane;
    const float v = k < K ? __ldg(sc + k) : -INFINITY;
    const unsigned live = __ballot_sync(FULL, active_key(v, score_thr) != 0u);
    bool alive = (live >> lane) & 1u;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (alive) {
      q = base == 0 ? first_q : load_box(bx, k, aligned);
      for (int j = 0; j < np && alive; ++j) {
        const float4 p = pbox[j];
        alive = !kills(p, box_area(p), q, iou_thr, thr_lo, thr_hi);
      }
    }
    unsigned surv = __ballot_sync(FULL, alive);
    while (surv != 0u && np < D) {  // the chunk's own greedy order, lowest lane first
      const int l = __ffs(surv) - 1;
      const float4 p = make_float4(__shfl_sync(FULL, q.x, l), __shfl_sync(FULL, q.y, l),
                                   __shfl_sync(FULL, q.z, l), __shfl_sync(FULL, q.w, l));
      const float ps = __shfl_sync(FULL, v, l);
      if (lane == 0) {
        pbox[np] = p;
        pscore[np] = ps;
      }
      ++np;
      if (lane <= l || (alive && kills(p, box_area(p), q, iou_thr, thr_lo, thr_hi)))
        alive = false;
      surv = __ballot_sync(FULL, alive);
    }
    __syncwarp();  // lane 0's picks are visible to the next chunk's tests
    if (live != FULL) break;  // an inactive key: every later key is inactive too
  }
  __syncwarp();
  float4* ob = reinterpret_cast<float4*>(out_boxes) + size_t(bc) * D;
  float* os = out_scores + size_t(bc) * D;
  for (int t = lane; t < D; t += 32) {
    os[t] = t < np ? pscore[t] : empty_score;
    ob[t] = t < np ? pbox[t] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <bool STAGED>  // boxes in shared memory for all rounds, or read from device memory
__global__ void __launch_bounds__((STAGED ? ROUNDS_WARPS : ROUNDS_WARPS_GLOBAL) * 32)
    nms_large_rounds(const float* __restrict__ scores, const float* __restrict__ boxes,
                     float* __restrict__ out_boxes, float* __restrict__ out_scores,
                     const int* __restrict__ unsorted, int BC, int C, int K, int D,
                     long long box_bstride, long long box_cstride, float iou_thr, float thr_lo,
                     float thr_hi, float score_thr, float empty_score) {
  constexpr int NW = STAGED ? ROUNDS_WARPS : ROUNDS_WARPS_GLOBAL;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);                        // [K] if STAGED
  uint32_t* skey = reinterpret_cast<uint32_t*>(sbox + (STAGED ? K : 0));  // [K]
  uint32_t* wkey = skey + ((K + 3) & ~3);                                 // [2][NW]
  unsigned* widx = wkey + 2 * NW;                                         // [2][NW]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  // This CTA's pools are blockIdx.x + j * gridDim.x; every warp reads the
  // flags of 32 of them at once and takes the flagged ones in turn.
  for (int j0 = 0; blockIdx.x + j0 * gridDim.x < BC; j0 += 32) {
    const int mine = blockIdx.x + (j0 + lane) * gridDim.x;
    unsigned todo = __ballot_sync(FULL, mine < BC && unsorted[mine] != 0);
    while (todo != 0u) {
      const int bc = blockIdx.x + (j0 + __ffs(todo) - 1) * gridDim.x;
      todo &= todo - 1;
      const int b = bc / C, c = bc - b * C;
      const float* sc = scores + size_t(bc) * K;
      const float* bx = boxes + b * box_bstride + c * box_cstride;
      const bool aligned = (reinterpret_cast<uintptr_t>(bx) & 15) == 0;
      __syncthreads();  // the previous pool's last round has read its boxes and winners
#pragma unroll 4
      for (int k = tid; k < K; k += nthreads) {
        skey[k] = active_key(__ldg(sc + k), score_thr);
        if (STAGED) sbox[k] = load_box(bx, k, aligned);
      }  // keys: each thread's own; boxes: read after the first round's barrier

      float4* ob = reinterpret_cast<float4*>(out_boxes) + size_t(bc) * D;
      float* os = out_scores + size_t(bc) * D;
      int r = 0;
      for (; r < D; ++r) {
        uint32_t best = 0u;
        unsigned bi = 0xffffffffu;
        for (int k = tid; k < K; k += nthreads) {  // ascending index: strict > keeps the lowest
          const uint32_t key = skey[k];
          if (key > best) {
            best = key;
            bi = unsigned(k);
          }
        }
        const uint32_t wtop = __reduce_max_sync(FULL, best);
        const unsigned wi = __reduce_min_sync(FULL, best == wtop ? bi : 0xffffffffu);
        const int buf = (r & 1) * NW;
        if (lane == 0) {
          wkey[buf + warp] = wtop;
          widx[buf + warp] = wi;
        }
        __syncthreads();
        const uint32_t k2 = lane < NW ? wkey[buf + lane] : 0u;
        const unsigned i2 = lane < NW ? widx[buf + lane] : 0xffffffffu;
        const uint32_t top = __reduce_max_sync(FULL, k2);
        if (top == 0u) break;  // nothing active is left (every warp reads the same winners)
        const int p = int(__reduce_min_sync(FULL, k2 == top ? i2 : 0xffffffffu));
        const float4 pb = STAGED ? sbox[p] : load_box(bx, p, aligned);
        if (tid == 0) {
          os[r] = __ldg(sc + p);
          ob[r] = pb;
        }
        const float pa = box_area(pb);
        for (int k = tid; k < K; k += nthreads) {
          if (skey[k] == 0u) continue;
          const float4 q = STAGED ? sbox[k] : load_box(bx, k, aligned);
          if (k == p || kills(pb, pa, q, iou_thr, thr_lo, thr_hi)) skey[k] = 0u;
        }
      }
      for (int t = r + tid; t < D; t += nthreads) {
        os[t] = empty_score;
        ob[t] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

// The margin test's bounds: thr * (1 -+ 2^-18). Outside [2^-60, 2^60] (or
// NaN) its products could leave the normal range, so infinite bounds
// settle nothing and every pair is divided.
void margin_bounds(float iou_thr, float& lo, float& hi) {
  const bool fast = iou_thr >= 0x1p-60f && iou_thr <= 0x1p60f;
  lo = fast ? float(double(iou_thr) * (1.0 - 0x1p-18)) : -INFINITY;
  hi = fast ? float(double(iou_thr) * (1.0 + 0x1p-18)) : INFINITY;
}

template <int NPL>
cudaError_t launch(const void* scores, const void* boxes, void* out_boxes, void* out_scores,
                   int B, int C, int K, int D, long long bstride, long long cstride,
                   float iou_thr, float score_thr, float empty_score, int variant, int warps,
                   int cs, int smem, cudaStream_t stream) {
  if (variant == VARIANT_PER_CLASS) {
    const int blocks = (B * C + WARPS - 1) / WARPS;
    nms_kernel<NPL><<<blocks, WARPS * 32, 0, stream>>>(
        static_cast<const float*>(scores), static_cast<const float*>(boxes),
        static_cast<float*>(out_boxes), static_cast<float*>(out_scores), B, C, K, D, bstride,
        cstride, iou_thr, score_thr, empty_score);
    return cudaGetLastError();
  }
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_shared<NPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    smem_allowed = SMEM_LIMIT;
  }
  float lo, hi;
  margin_bounds(iou_thr, lo, hi);
  nms_shared<NPL><<<B, warps * 32, smem, stream>>>(
      static_cast<const float*>(scores), static_cast<const float*>(boxes),
      static_cast<float*>(out_boxes), static_cast<float*>(out_scores), C, K, D, bstride, cs,
      iou_thr, lo, hi, score_thr, empty_score);
  return cudaGetLastError();
}

template <bool STAGED>
cudaError_t launch_rounds(const void* scores, const void* boxes, void* out_boxes,
                          void* out_scores, const int* flags, int B, int C, int K, int D,
                          long long bstride, long long cstride, float iou_thr, float lo, float hi,
                          float score_thr, float empty_score, int smem, cudaStream_t stream) {
  constexpr int threads = (STAGED ? ROUNDS_WARPS : ROUNDS_WARPS_GLOBAL) * 32;
  static int smem_allowed = 48 * 1024;
  cudaError_t e;
  if (smem > smem_allowed) {
    e = cudaFuncSetAttribute(nms_large_rounds<STAGED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    smem_allowed = SMEM_LIMIT;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nms_large_rounds<STAGED>,
                                                         threads, smem)) != cudaSuccess)
    return e;
  const int grid = per_sm < 1 ? 1 : (B * C < per_sm * sms ? B * C : per_sm * sms);
  nms_large_rounds<STAGED><<<grid, threads, smem, stream>>>(
      static_cast<const float*>(scores), static_cast<const float*>(boxes),
      static_cast<float*>(out_boxes), static_cast<float*>(out_scores), flags, B * C, C, K, D,
      bstride, cstride, iou_thr, lo, hi, score_thr, empty_score);
  return cudaGetLastError();
}

// The sorted pools' walk, then the rounds of the pools it flags.
cudaError_t launch_large(const void* scores, const void* boxes, void* out_boxes,
                         void* out_scores, int* flags, int B, int C, int K, int D,
                         long long bstride, long long cstride, float iou_thr, float score_thr,
                         float empty_score, int warps, int smem, cudaStream_t stream) {
  float lo, hi;
  margin_bounds(iou_thr, lo, hi);
  const int walk_smem = int(walk_smem_bytes(D));
  static int walk_allowed = 48 * 1024;
  if (walk_smem > walk_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_large_walk, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    walk_allowed = SMEM_LIMIT;
  }
  nms_large_walk<<<B * C, WALK_WARPS * 32, walk_smem, stream>>>(
      static_cast<const float*>(scores), static_cast<const float*>(boxes),
      static_cast<float*>(out_boxes), static_cast<float*>(out_scores), flags, C, K, D, bstride,
      cstride, iou_thr, lo, hi, score_thr, empty_score);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return warps == ROUNDS_WARPS
             ? launch_rounds<true>(scores, boxes, out_boxes, out_scores, flags, B, C, K, D,
                                   bstride, cstride, iou_thr, lo, hi, score_thr, empty_score,
                                   smem, stream)
             : launch_rounds<false>(scores, boxes, out_boxes, out_scores, flags, B, C, K, D,
                                    bstride, cstride, iou_thr, lo, hi, score_thr, empty_score,
                                    smem, stream);
}

// Bytes of dynamic shared memory nms_shared<npl> lays out (ops/nms_kernel.py
// ::shared_smem_bytes computes the same).
long long shared_smem_bytes(int npl, int K, int cs, int warps, int D) {
  const long long mp = 32LL * npl;
  return 16 * mp + 4 * mp * npl + 4 * mp + 16 * ((cs * (long long)K + 3) / 4) +
         4LL * (warps < cs ? warps : cs) * D;
}

}  // namespace

extern "C" {

// scores [B, C, K] float32; boxes float32 (ymin, xmin, ymax, xmax) at
// boxes + b * box_bstride + c * box_cstride + 4 * k (in floats);
// out_boxes [B, C, D, 4], out_scores [B, C, D] float32; empty slots get a
// zero box and empty_score. variant 0 runs the per-class kernel (K <= 512,
// warps == 4, smem == 0); 1 the shared-pool kernel (K <= 512, box_cstride
// 0) with that many warps per CTA, scores in passes of cs classes and smem
// bytes of dynamic shared memory; 2 the large-pool kernels (any K whose
// keys fit in shared memory): the walk, then the rounds with that many
// warps per CTA and smem bytes, scratch an int32 [B * C] for the flags of
// unsorted pools (unused by the other variants). The plan is
// ops/nms_kernel.py::plan_nms's, refused if this file would lay it out
// differently. Returns the CUDA error of the launch (0 on success).
int yrt_nms(const void* scores, const void* boxes, void* out_boxes, void* out_scores, int B,
            int C, int K, int D, long long box_bstride, long long box_cstride, float iou_thr,
            float score_thr, float empty_score, int variant, int warps, int cs, int smem,
            void* scratch, void* stream) {
  if (K < 1 || D < 0 || B < 0 || C < 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == VARIANT_LARGE) {
    const bool staged = large_smem_bytes(K) == large_staged_bytes(K);
    if (warps != (staged ? ROUNDS_WARPS : ROUNDS_WARPS_GLOBAL) || smem > SMEM_LIMIT ||
        smem != large_smem_bytes(K) || walk_smem_bytes(D) > SMEM_LIMIT || scratch == nullptr)
      return int(cudaErrorInvalidValue);
    if (B * C == 0 || D == 0) return int(cudaSuccess);
    return int(launch_large(scores, boxes, out_boxes, out_scores, static_cast<int*>(scratch), B,
                            C, K, D, box_bstride, box_cstride, iou_thr, score_thr, empty_score,
                            warps, smem, s));
  }
  if (K > MAX_NPL * 32) return int(cudaErrorInvalidValue);
  const int npl = K <= 32 ? 1 : K <= 64 ? 2 : K <= 128 ? 4 : K <= 256 ? 8 : 16;
  if (variant == VARIANT_PER_CLASS && (warps != WARPS || smem != 0))
    return int(cudaErrorInvalidValue);
  if (variant == VARIANT_SHARED &&
      (box_cstride != 0 || warps < 1 || warps > MAX_SHARED_WARPS || cs < 1 || cs > C ||
       smem > SMEM_LIMIT || smem != shared_smem_bytes(npl, K, cs, warps, D)))
    return int(cudaErrorInvalidValue);
  if (variant != VARIANT_PER_CLASS && variant != VARIANT_SHARED) return int(cudaErrorInvalidValue);
  if (B * C == 0 || D == 0) return int(cudaSuccess);
  cudaError_t e;
  switch (npl) {
    case 1:
      e = launch<1>(scores, boxes, out_boxes, out_scores, B, C, K, D, box_bstride, box_cstride,
                    iou_thr, score_thr, empty_score, variant, warps, cs, smem, s);
      break;
    case 2:
      e = launch<2>(scores, boxes, out_boxes, out_scores, B, C, K, D, box_bstride, box_cstride,
                    iou_thr, score_thr, empty_score, variant, warps, cs, smem, s);
      break;
    case 4:
      e = launch<4>(scores, boxes, out_boxes, out_scores, B, C, K, D, box_bstride, box_cstride,
                    iou_thr, score_thr, empty_score, variant, warps, cs, smem, s);
      break;
    case 8:
      e = launch<8>(scores, boxes, out_boxes, out_scores, B, C, K, D, box_bstride, box_cstride,
                    iou_thr, score_thr, empty_score, variant, warps, cs, smem, s);
      break;
    default:
      e = launch<16>(scores, boxes, out_boxes, out_scores, B, C, K, D, box_bstride,
                     box_cstride, iou_thr, score_thr, empty_score, variant, warps, cs, smem, s);
  }
  return int(e);
}

const char* yrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
