// Greedy class-aware NMS for Hopper: one warp per (image, class).
//
// Replaces the TPU kernel yoloret_tpu/ops/nms_pallas.py::_nms_kernel
// (nms_fused) and, on the serving path, the XLA loop
// yoloret_tpu/ops/postprocess.py::_suppress_lax_shared. Python side:
// ops/nms_kernel.py.
//
// Per (image, class), max_det rounds: take the highest active score
// (ties to the lowest candidate index), emit it with its box, deactivate
// the pick and every candidate whose IoU with it is strictly above the
// threshold. Scores below the score threshold start inactive; empty
// slots are written as zeros.
//
// What bounds it: the operations of the loop (rounds x candidates x one
// IoU), not bytes -- its inputs are read once (at most 512 candidates
// per warp). Design: the candidates are strided over the 32 lanes and
// held in registers for all rounds (scores, the four coordinates and the
// area), so a round is a lane-local scan, a 5-step shuffle argmax over
// (score, -index), a shuffle broadcast of the pick's box from its owner
// lane, and one IoU per candidate -- no shared memory, no barrier, no
// device-memory traffic inside the loop. A warp stops at the first round
// with nothing left to pick. Boxes come with a class stride: 0 for the
// shared pool [B, M, 4] of the serving path, K*4 for per-class pools
// [B, C, K, 4]. Built with -fmad=false so the IoU rounds exactly as the
// plain PyTorch version's does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;  // warps per block
constexpr unsigned FULL = 0xffffffffu;

template <int NPL>  // candidates per lane
__global__ void __launch_bounds__(WARPS * 32)
    nms_kernel(const float* __restrict__ scores, const float* __restrict__ boxes,
               float* __restrict__ out_boxes, float* __restrict__ out_scores, int B, int C,
               int K, int D, long long box_bstride, long long box_cstride, float iou_thr,
               float score_thr) {
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
    os[t] = 0.f;
    ob[4 * t + 0] = ob[4 * t + 1] = ob[4 * t + 2] = ob[4 * t + 3] = 0.f;
  }
}

template <int NPL>
cudaError_t launch(const void* scores, const void* boxes, void* out_boxes, void* out_scores,
                   int B, int C, int K, int D, long long bstride, long long cstride,
                   float iou_thr, float score_thr, cudaStream_t stream) {
  const int blocks = (B * C + WARPS - 1) / WARPS;
  nms_kernel<NPL><<<blocks, WARPS * 32, 0, stream>>>(
      static_cast<const float*>(scores), static_cast<const float*>(boxes),
      static_cast<float*>(out_boxes), static_cast<float*>(out_scores), B, C, K, D, bstride,
      cstride, iou_thr, score_thr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int yrt_nms_max_candidates() { return 16 * 32; }

// scores [B, C, K] float32; boxes float32 (ymin, xmin, ymax, xmax) at
// boxes + b * box_bstride + c * box_cstride + 4 * k (in floats);
// out_boxes [B, C, D, 4], out_scores [B, C, D] float32.
// Returns the CUDA error of the launch (0 on success).
int yrt_nms(const void* scores, const void* boxes, void* out_boxes, void* out_scores, int B,
            int C, int K, int D, long long box_bstride, long long box_cstride, float iou_thr,
            float score_thr, void* stream) {
  if (K < 1 || K > 16 * 32 || D < 0) return int(cudaErrorInvalidValue);
  if (B * C == 0 || D == 0) return int(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npl = (K + 31) / 32;
  cudaError_t e;
  if (npl <= 1)
    e = launch<1>(scores, boxes, out_boxes, out_scores, B, C, K, D, box_bstride, box_cstride,
                  iou_thr, score_thr, s);
  else if (npl <= 2)
    e = launch<2>(scores, boxes, out_boxes, out_scores, B, C, K, D, box_bstride, box_cstride,
                  iou_thr, score_thr, s);
  else if (npl <= 4)
    e = launch<4>(scores, boxes, out_boxes, out_scores, B, C, K, D, box_bstride, box_cstride,
                  iou_thr, score_thr, s);
  else if (npl <= 8)
    e = launch<8>(scores, boxes, out_boxes, out_scores, B, C, K, D, box_bstride, box_cstride,
                  iou_thr, score_thr, s);
  else
    e = launch<16>(scores, boxes, out_boxes, out_scores, B, C, K, D, box_bstride,
                   box_cstride, iou_thr, score_thr, s);
  return int(e);
}

const char* yrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
