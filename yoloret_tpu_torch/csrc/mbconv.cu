// Fused inverted-residual (MBConv) block for Hopper, NHWC, BN folded:
//   expand 1x1 + ReLU6 -> depthwise 3x3 "SAME" + ReLU6 -> project 1x1
//   [+ residual], stride 1 or 2, with or without the expand conv.
//
// Replaces the TPU kernels yoloret_tpu/ops/mbconv_pallas.py::_kernel_s1 /
// _kernel_s2 (fused_mbconv) and yoloret_tpu/ops/mbconv_pallas2.py::
// _cp_kernel (fused_mbconv2_cp). Python side, tile plan and weight
// packing: ops/mbconv.py.
//
// What bounds it on an H100. Unfused, each block writes and re-reads its
// 6x-expanded tensor; fused, it moves only its input, its output and its
// weights. At b128@320 that leaves blocks 0-6 (160x160 to 40x40 maps,
// Cin <= 24) bound by device-memory bytes and blocks 7-15 (20x20 and
// 10x10, Ce 288-720) by tensor-core operations; the two bounds sum to
// 0.22 ms for the 16 blocks. In practice the kernel is bound by how well
// it keeps the CUDA cores busy: the depthwise and the expand epilogue are
// CUDA-core work, and with 8-16 consumer warps per SM their shared-memory
// and wgmma latencies are only partly hidden.
//
// bfloat16 (the serving path), mbconv_wgmma: a persistent, warp-
// specialised kernel. Each CTA walks (image, output tile) work items.
// - A producer warpgroup (its registers given to the consumers with
//   setmaxnreg) issues all loads from one thread: the input tile with its
//   halo by TMA (cp.async.bulk.tensor over a 4-D tensor map of the NHWC
//   input, one box per 8 channels; the box starts at row/column -1, and
//   out-of-bounds elements, image padding, arrive as zeros), and the
//   weights, packed once on the host (ops/mbconv.py::pack_mbconv) into
//   this kernel's shared-memory layout, one contiguous run per chunk of 48
//   expanded channels, by 1-D bulk copy (cp.async.bulk). Both go through
//   mbarrier rings (1-2 input stages, 2-3 weight stages), so the next
//   chunk and the next tile load while this one computes; nothing is
//   transposed or gathered in the kernel.
// - One to four consumer warpgroups, 64 output pixels each, run per
//   chunk: the expand on wgmma (A = input tile, B = weight chunk, both in
//   shared memory; accumulators in registers), whose epilogue adds the
//   bias, applies ReLU6, zeroes image padding and stores the chunk as
//   bf16 (double-buffered); then the depthwise on the CUDA cores, f32
//   sums, rounded to bf16 straight into the register A fragments of the
//   project wgmma (B = projection chunk in shared memory), whose
//   accumulators stay in registers across all chunks. The next chunk's
//   first expand block runs on the tensor cores during this chunk's
//   depthwise. Without expand the depthwise reads the input tile itself.
// - Consumers meet at one named barrier per chunk (the expanded chunk is
//   read across warpgroups); weight and input stages are released to the
//   producer through mbarriers. Padded expanded channels carry zero
//   weights and biases, so relu6(0) = 0 and no chunk needs a ragged-edge
//   mask.
// Tiles grow to 256 output pixels (a 10x10 map is one item per image);
// ops/mbconv.py::plan_tile chooses them and sizes the grid to the SMs.
// Against the first version of this kernel (commit 46a8f8c) this removes
// the per-tile scalar weight gathers
// and transposes, the four block-wide barriers per chunk, the f32 expanded
// chunk (now bf16, half the shared memory and reads) and the depthwise
// round trip through shared memory.
//
// Values are rounded to bf16 where the JAX kernel rounds (after the
// expand, after the depthwise, at the output); sums are float32.
//
// float32 (checks against the plain version), mbconv_f32: the same steps
// as fp32 FMAs on the CUDA cores, register-blocked, one output tile per
// thread block; its tile is chosen here (choose_tile_f32).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float relu6f(float v) { return fminf(fmaxf(v, 0.f), 6.f); }
__host__ __device__ constexpr size_t align16(size_t v) { return (v + 15) & ~size_t(15); }
__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// ---------------------------------------------------------------------------
// float32: CUDA-core kernel, one output tile per thread block
// ---------------------------------------------------------------------------

constexpr int F_NT = 256;      // threads per block
constexpr int F_CH = 32;       // expanded channels per chunk
constexpr int F_ES = F_CH + 8; // row stride of the expanded chunk (no bank conflicts)
constexpr int F_DS = F_CH + 1; // row stride of the depthwise chunk (no bank conflicts)
constexpr int F_MAX_TILE = 16; // output tile side limit
constexpr int F_MAX_RQ = 4;    // project pixels per thread

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

struct FLayout {  // tile geometry and byte offsets into dynamic shared memory
  int win, pin, pinr, pout, poutp;
  size_t e, d, we, wp, wd, total;
};

__host__ __device__ inline FLayout f_layout(int stride, int th, int tw, int rq, int cin,
                                            int cout) {
  FLayout l;
  l.win = (tw - 1) * stride + 3;
  l.pin = ((th - 1) * stride + 3) * l.win;
  l.pout = th * tw;
  l.pinr = round_up(l.pin, 4);
  l.poutp = round_up(l.pout, rq);
  l.e = align16(size_t(l.pinr) * cin * 4);            // x tile [PINR][Cin]
  l.d = l.e + align16(size_t(l.pin) * F_ES * 4);      // expanded chunk [PIN][ES]
  l.we = l.d + align16(size_t(l.poutp) * F_DS * 4);   // depthwise chunk [POUTP][DS]
  l.wp = l.we + align16(size_t(cin) * F_CH * 4);      // expand weights [Cin][CH]
  l.wd = l.wp + align16(size_t(F_CH) * cout * 4);     // project weights [CH][Cout]
  l.total = l.wd + align16(size_t(9) * F_CH * 4);     // depthwise weights [9][CH]
  return l;
}

template <int S>
__global__ void __launch_bounds__(F_NT) mbconv_f32(
    const float* __restrict__ x, const float* __restrict__ we, const float* __restrict__ be,
    const float* __restrict__ wd, const float* __restrict__ bd, const float* __restrict__ wp,
    const float* __restrict__ bp, float* __restrict__ out, int H, int W, int Cin, int Ce,
    int Cout, int expand, int residual, int th, int tw, int rq, int tiles_w) {
  constexpr int PAD = S == 1 ? 1 : 0;  // "SAME": (1, 1) at stride 1, (0, 1) at stride 2
  const FLayout L = f_layout(S, th, tw, rq, Cin, Cout);
  const int win = L.win, PIN = L.pin;
  const int Ho = H / S, Wo = W / S;
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_w) * th, ox0 = (blockIdx.x % tiles_w) * tw;
  const int iy0 = oy0 * S - PAD, ix0 = ox0 * S - PAD;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* x_s = reinterpret_cast<float*>(smem);
  float* e_s = reinterpret_cast<float*>(smem + L.e);
  float* d_s = reinterpret_cast<float*>(smem + L.d);
  float* we_s = reinterpret_cast<float*>(smem + L.we);
  float* wp_s = reinterpret_cast<float*>(smem + L.wp);
  float* wd_s = reinterpret_cast<float*>(smem + L.wd);

  // input tile with its halo, 16 bytes a load; image padding is zero
  const float* xb = x + size_t(b) * H * W * Cin;
  for (int i = tid; i < L.pinr * (Cin / 4); i += F_NT) {
    const int p = i / (Cin / 4), c = (i - p * (Cin / 4)) * 4;
    const int gy = iy0 + p / win, gx = ix0 + p % win;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < PIN && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = *reinterpret_cast<const float4*>(xb + (size_t(gy) * W + gx) * Cin + c);
    *reinterpret_cast<float4*>(x_s + p * Cin + c) = v;
  }

  // project accumulators: rq pixels x 8 channels per thread
  const int cgs = Cout / 8;
  const bool owner = tid < (L.poutp / rq) * cgs;
  const int q0 = (tid / cgs) * rq, co0 = (tid % cgs) * 8;
  float acc[F_MAX_RQ * 8];
#pragma unroll
  for (int r = 0; r < F_MAX_RQ * 8; ++r) acc[r] = 0.f;

  for (int c0 = 0; c0 < Ce; c0 += F_CH) {
    const int nc = min(F_CH, Ce - c0);
    if (expand) {
      for (int i = tid; i < Cin * F_CH; i += F_NT) {
        const int k = i / F_CH, j = i - k * F_CH;
        we_s[i] = j < nc ? we[size_t(k) * Ce + c0 + j] : 0.f;
      }
    }
    for (int i = tid; i < F_CH * Cout; i += F_NT) {
      const int j = i / Cout, co = i - j * Cout;
      wp_s[i] = j < nc ? wp[size_t(c0 + j) * Cout + co] : 0.f;
    }
    for (int i = tid; i < 9 * F_CH; i += F_NT) {
      const int tap = i / F_CH, j = i - tap * F_CH;
      wd_s[i] = j < nc ? wd[tap * Ce + c0 + j] : 0.f;
    }
    __syncthreads();

    // expand + ReLU6 over the halo tile; image padding stays zero
    for (int i = tid; i < (L.pinr / 4) * F_CH; i += F_NT) {
      const int p0 = (i / F_CH) * 4, j = i % F_CH;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < nc && expand) {
        for (int k = 0; k < Cin; k += 4) {
          const float w0 = we_s[k * F_CH + j], w1 = we_s[(k + 1) * F_CH + j];
          const float w2 = we_s[(k + 2) * F_CH + j], w3 = we_s[(k + 3) * F_CH + j];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float xv[4];
            load4(x_s + (p0 + r) * Cin + k, xv);
            a[r] += xv[0] * w0;
            a[r] += xv[1] * w1;
            a[r] += xv[2] * w2;
            a[r] += xv[3] * w3;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = p0 + r;
        if (p >= PIN) continue;
        const int gy = iy0 + p / win, gx = ix0 + p % win;
        float v = 0.f;
        if (j < nc && gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = expand ? relu6f(a[r] + be[c0 + j]) : x_s[p * Cin + c0 + j];
        e_s[p * F_ES + j] = v;
      }
    }
    __syncthreads();

    // depthwise 3x3 + ReLU6 at the output pixels; padded rows are zero
    for (int i = tid; i < L.poutp * F_CH; i += F_NT) {
      const int q = i / F_CH, j = i - q * F_CH;
      float v = 0.f;
      if (q < L.pout && j < nc) {
        const int oy = q / tw, ox = q - oy * tw;
        float a = 0.f;
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj)
            a += e_s[((oy * S + di) * win + ox * S + dj) * F_ES + j] *
                 wd_s[(di * 3 + dj) * F_CH + j];
        v = relu6f(a + bd[c0 + j]);
      }
      d_s[q * F_DS + j] = v;
    }
    __syncthreads();

    // project partial sums
    if (owner) {
      for (int j = 0; j < F_CH; ++j) {
        float w[8];
        load4(wp_s + j * Cout + co0, w);
        load4(wp_s + j * Cout + co0 + 4, w + 4);
#pragma unroll
        for (int r = 0; r < F_MAX_RQ; ++r) {
          if (r < rq) {
            const float dv = d_s[(q0 + r) * F_DS + j];
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r * 8 + c] += dv * w[c];
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the weights and both tiles
  }

  // epilogue: + bias [+ residual], store the pixels inside the map
  if (!owner) return;
  float* ob = out + size_t(b) * Ho * Wo * Cout;
#pragma unroll
  for (int r = 0; r < F_MAX_RQ; ++r) {
    const int q = q0 + r;
    if (r >= rq || q >= L.pout) continue;
    const int qy = q / tw, qx = q - qy * tw;
    const int oy = oy0 + qy, ox = ox0 + qx;
    if (oy >= Ho || ox >= Wo) continue;
#pragma unroll
    for (int c = 0; c < 8; c += 2) {
      const int co = co0 + c;
      float v0 = acc[r * 8 + c] + bp[co], v1 = acc[r * 8 + c + 1] + bp[co + 1];
      if (S == 1 && residual) {
        const float* xr = x_s + ((qy + 1) * win + qx + 1) * Cin + co;
        v0 += xr[0];
        v1 += xr[1];
      }
      *reinterpret_cast<float2*>(ob + (size_t(oy) * Wo + ox) * Cout + co) = make_float2(v0, v1);
    }
  }
}

struct FTile {
  int th, tw, rq;
};

// The output tile with the lowest modelled cost per image: tiles x (the
// expand, depthwise and project steps of one tile + weight staging),
// counted per thread. A tile must fit the project accumulators (F_MAX_RQ
// x 8 per thread) and shared memory, for two resident blocks if possible.
bool choose_tile_f32(int Ho, int Wo, int stride, int Cin, int Cout, FTile* best) {
  double best_cost = 0;
  bool found = false;
  const size_t limits[2] = {113 * 1024, 227 * 1024};
  for (size_t limit : limits) {
    for (int th = 1; th <= F_MAX_TILE && th <= Ho; ++th) {
      for (int tw = 1; tw <= F_MAX_TILE && tw <= Wo; ++tw) {
        int rq = 1;
        while (rq <= F_MAX_RQ && (round_up(th * tw, rq) / rq) * (Cout / 8) > F_NT) rq *= 2;
        if (rq > F_MAX_RQ) continue;
        const FLayout l = f_layout(stride, th, tw, rq, Cin, Cout);
        if (l.total > limit) continue;
        const double tiles = double((Ho + th - 1) / th) * ((Wo + tw - 1) / tw);
        const double depthwise = double((l.poutp * F_CH + F_NT - 1) / F_NT) * 9;
        const double staging = 4.0 * double((Cin + Cout) * F_CH) / F_NT;
        const double expand = double((l.pinr / 4 * F_CH + F_NT - 1) / F_NT) * 4 * Cin;
        const double project = double(F_CH) * rq * 8;
        const double cost = tiles * (expand + depthwise + project + staging);
        if (!found || cost < best_cost) {
          best_cost = cost;
          *best = FTile{th, tw, rq};
          found = true;
        }
      }
    }
    if (found) return true;
  }
  return false;
}

template <int S>
cudaError_t launch_f32(const float* x, const float* we, const float* be, const float* wd,
                       const float* bd, const float* wp, const float* bp, float* out, int B,
                       int H, int W, int Cin, int Ce, int Cout, int expand, int residual,
                       cudaStream_t stream) {
  const int Ho = H / S, Wo = W / S;
  FTile t;
  if (!choose_tile_f32(Ho, Wo, S, Cin, Cout, &t)) return cudaErrorInvalidValue;
  const int tiles_w = (Wo + t.tw - 1) / t.tw, tiles_h = (Ho + t.th - 1) / t.th;
  const size_t smem = f_layout(S, t.th, t.tw, t.rq, Cin, Cout).total;
  cudaError_t e =
      cudaFuncSetAttribute(mbconv_f32<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  mbconv_f32<S><<<dim3(tiles_w * tiles_h, B), F_NT, smem, stream>>>(
      x, we, be, wd, bd, wp, bp, out, H, W, Cin, Ce, Cout, expand, residual, t.th, t.tw, t.rq,
      tiles_w);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: warp-specialised Hopper kernel (TMA, mbarrier rings, wgmma)
// ---------------------------------------------------------------------------

constexpr int CH = 48;          // expanded channels per chunk: expand wgmma N, project K
constexpr int KS = CH / 16;     // project k16 steps per chunk
constexpr int NBW = 24;         // project wgmma N per instruction (Cout padded to it)
// bf16 row stride of an expanded chunk: a half-warp's depthwise reads
// (8 bytes each) hit rows 2 (stride 1) or 4 (stride 2) halo pixels apart,
// which these strides spread over all 32 banks
__host__ __device__ constexpr int es(int stride) { return stride == 1 ? CH + 8 : CH + 4; }
constexpr int MAX_NC = 4;       // consumer warpgroups, 64 output pixels each
// Consumer warpgroups a kernel with NB accumulator blocks launches at
// most: four while the project sums are small (Cout <= 48), else three;
// with the producer warpgroup that is 640 or 512 threads at 96 or 128
// registers, and the consumers take 112 or 160 each from what the
// producer gives back (setmaxnreg moves registers within the CTA).
__host__ __device__ constexpr int max_nc(int nb) { return nb <= 2 ? 4 : 3; }
constexpr int BAR_BYTES = 128;  // mbarriers at the start of shared memory
constexpr int MAX_STAGES = 3;
constexpr int SMEM_LIMIT = 232448;  // 227 KB a block can use on sm_90

// Geometry of one launch; the host fills it (h_layout) from the tile plan.
struct HParams {
  const unsigned char* w;  // packed weights, nchunks x chunk_bytes
  const float* bp;
  bf16* out;
  int H, W, Cin, Ce, Cout, nchunks, expand, residual;
  int th, tw, nc, xst, wst, tiles_w, items_per_image, items;
  int kpad, coutp, win, hin, pin, pinp;
  // bytes: one input stage, one weight chunk and its parts, shared-memory offsets
  uint32_t x_bytes, chunk_bytes, w_stride, wp_off, wd_off, be_off, bd_off;
  uint32_t x_off, w_off, e_off, e_bytes, smem;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// Wait until the phase of this parity has completed. A pipeline fault
// traps (a launch error) after some 2 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  const long long start = clock64();
  do {
    if ((++polls & 1023) == 0 && clock64() - start > (1ll << 32)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// TMA: a box of the 4-D tensor map (c, x, y, image) into shared memory.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c, int x, int y, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(x), "r"(y), "r"(n)
      : "memory");
}
// 1-D bulk copy of a contiguous run (16-byte multiple) into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor, no swizzle: 8x16-byte core matrices;
// lbo = byte stride between core matrices along K, sbo = along M/N.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}
// Keep the compiler from moving register reads or writes across a wgmma
// wait (the hardware owns accumulators and A fragments until then).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// D[64x48] (+)= A[64x16] . B[16x48]^T, A and B in shared memory (K-major).
__device__ __forceinline__ void wgmma_m64n48_ss(float (&d)[24], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64x24] += A[64x16] . B[16x24]^T, A in registers, B in shared memory.
__device__ __forceinline__ void wgmma_m64n24_rs(float (&d)[12], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void fma4(float s[4], const float e[4], const float4 w) {
  s[0] = fmaf(e[0], w.x, s[0]);
  s[1] = fmaf(e[1], w.y, s[1]);
  s[2] = fmaf(e[2], w.z, s[2]);
  s[3] = fmaf(e[3], w.w, s[3]);
}

// Four bf16 at an 8-byte aligned address, as float.
__device__ __forceinline__ void load_bf16x4(const bf16* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// relu6 of two floats, rounded to bf16 and packed (lo in the low half):
// round(min(max(v, 0), 6)) = min(round(max(v, 0)), 6), rounding being
// monotonic and 6 a bf16 value, so this is exact.
__device__ __forceinline__ uint32_t relu6_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  asm("min.bf16x2 %0, %0, %1;" : "+r"(r) : "r"(0x40C040C0u));  // 6.0, 6.0
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// NB: capacity of the project accumulators in wgmma N blocks of 24 (the
// launch uses coutp / 24 <= NB of them).
template <int S, int NB>
__global__ void __launch_bounds__(128 * (max_nc(NB) + 1), 1)
    mbconv_wgmma(const __grid_constant__ CUtensorMap tmap, const HParams p) {
  constexpr int PAD = S == 1 ? 1 : 0;  // "SAME": (1, 1) at stride 1, (0, 1) at stride 2
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;  // shared address, 128-byte aligned
  unsigned char* sm = smem_raw + (base - raw);
  // mbarriers: x_full[3], x_empty[3], w_full[3], w_empty[3]
  auto x_full = [&](int i) { return base + 8 * i; };
  auto x_empty = [&](int i) { return base + 8 * (MAX_STAGES + i); };
  auto w_full = [&](int i) { return base + 8 * (2 * MAX_STAGES + i); };
  auto w_empty = [&](int i) { return base + 8 * (3 * MAX_STAGES + i); };
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;

  if (tid == 0) {
    // empties count one arrival per consumer warp
    for (int i = 0; i < p.xst; ++i) {
      mbar_init(x_full(i), 1);
      mbar_init(x_empty(i), 4 * p.nc);
    }
    for (int i = 0; i < p.wst; ++i) {
      mbar_init(w_full(i), 1);
      mbar_init(w_empty(i), 4 * p.nc);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // zero the input stages once: TMA writes only the real channels and
  // halo rows, so the K padding and the rows past the halo stay zero
  for (uint32_t i = tid * 16; i < p.xst * p.x_bytes; i += blockDim.x * 16)
    *reinterpret_cast<uint4*>(sm + p.x_off + i) = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  if (wg == p.nc) {
    // ---- producer warpgroup: one thread issues every load ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 128 * p.nc) {
      int xs = 0, ws = 0;
      uint32_t xph = 0, wph = 0;
      const uint32_t x_tx = uint32_t(p.Cin / 8) * p.win * p.hin * 16;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const int img = item / p.items_per_image, t = item % p.items_per_image;
        const int iy0 = (t / p.tiles_w) * p.th * S - PAD, ix0 = (t % p.tiles_w) * p.tw * S - PAD;
        mbar_wait(x_empty(xs), xph ^ 1);
        mbar_expect_tx(x_full(xs), x_tx);
        const uint32_t xdst = base + p.x_off + xs * p.x_bytes;
        for (int j = 0; j < p.Cin / 8; ++j)  // one box per 8 channels: [pixel][8] runs
          tma_load_4d(xdst + j * p.pinp * 16, &tmap, x_full(xs), 8 * j, ix0, iy0, img);
        if (++xs == p.xst) { xs = 0; xph ^= 1; }
        for (int c = 0; c < p.nchunks; ++c) {
          mbar_wait(w_empty(ws), wph ^ 1);
          mbar_expect_tx(w_full(ws), p.chunk_bytes);
          bulk_load(base + p.w_off + ws * p.w_stride, p.w + size_t(c) * p.chunk_bytes,
                    p.chunk_bytes, w_full(ws));
          if (++ws == p.wst) { ws = 0; wph ^= 1; }
        }
      }
    }
  } else {
    // ---- consumers: expand, depthwise, project --------------------------
    if constexpr (max_nc(NB) == 4)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    const int wid = (tid / 32) % 4, g = lane >> 2, t4 = lane & 3;
    const int nthreads = 128 * p.nc;
    const int win = p.win, pout = p.th * p.tw, Ho = p.H / S, Wo = p.W / S;
    const int nbr = p.coutp / NBW, n_mb = p.pinp / 64, ksteps = p.kpad / 16;
    // this thread's two rows of the project GEMM, g and g + 8 of its warp's
    // 16, are two neighbouring output pixels of one tile row (tw is even),
    // so their 3x3 windows share taps; hb: the window's top-left halo pixel
    const int q0 = 64 * wg + 16 * wid + 2 * g;
    const int hb = q0 < pout ? (q0 / p.tw) * S * win + (q0 % p.tw) * S : 0;
    const uint32_t lbo_x = p.pinp * 16, lbo_we = (CH / 8) * 128, lbo_wp = (p.coutp / 8) * 128;
    int xs = 0, ws = 0;
    uint32_t xph = 0, wph = 0, ebuf = 0;
    float acc[NB][12];
    float d[24];  // expand accumulators of one 64-row block

    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const int img = item / p.items_per_image, t = item % p.items_per_image;
      const int oy0 = (t / p.tiles_w) * p.th, ox0 = (t % p.tiles_w) * p.tw;
      const int iy0 = oy0 * S - PAD, ix0 = ox0 * S - PAD;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int i = 0; i < 12; ++i) acc[nb][i] = 0.f;
        fence_regs(acc[nb]);  // zeroed before, not inside, the first wgmma stage
      }
      mbar_wait(x_full(xs), xph);
      const uint32_t xa = base + p.x_off + xs * p.x_bytes;
      const bf16* x_s = reinterpret_cast<const bf16*>(sm + p.x_off + xs * p.x_bytes);

      // expand of 64-row block mb of a chunk (weights at shared address
      // wa): issue its k16 steps into d, asynchronously
      auto expand_issue = [&](int mb, uint32_t wa) {
        wg_fence();
        for (int k = 0; k < ksteps; ++k)
          wgmma_m64n48_ss(d, gmma_desc(xa + 2 * k * lbo_x + mb * 1024, lbo_x, 128),
                          gmma_desc(wa + 2 * k * lbo_we, lbo_we, 128), k > 0);
        wg_commit();
      };
      // its epilogue: + bias, ReLU6, image padding zeroed after the ReLU6,
      // bf16 into the expanded chunk e_s
      auto expand_store = [&](int mb, const unsigned char* w_s, bf16* e_s) {
        fence_regs(d);
        const float* be_s = reinterpret_cast<const float*>(w_s + p.be_off);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mb * 64 + 16 * wid + g + 8 * h;
          if (r >= p.pin) continue;
          const int hy = r / win, hx = r - hy * win;
          const int gy = iy0 + hy, gx = ix0 + hx;
          const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
#pragma unroll
          for (int i = 0; i < CH / 8; ++i) {
            const int j = 8 * i + 2 * t4;
            const float2 b = *reinterpret_cast<const float2*>(be_s + j);
            const uint32_t v = relu6_bf16x2(d[4 * i + 2 * h] + b.x, d[4 * i + 2 * h + 1] + b.y);
            *reinterpret_cast<uint32_t*>(e_s + r * es(S) + j) = in ? v : 0u;
          }
        }
      };
      // this warpgroup's blocks of a chunk from block mb0 on, one at a time
      auto expand_blocks = [&](int mb0, uint32_t wa, const unsigned char* w_s, bf16* e_s) {
        for (int mb = mb0; mb < n_mb; mb += p.nc) {
          expand_issue(mb, wa);
          wg_wait0();
          expand_store(mb, w_s, e_s);
        }
      };
      auto stage_addr = [&](int s) { return base + p.w_off + s * p.w_stride; };
      auto stage_ptr = [&](int s) { return sm + p.w_off + s * p.w_stride; };
      auto e_ptr = [&](uint32_t b) {
        return reinterpret_cast<bf16*>(sm + p.e_off + b * p.e_bytes);
      };

      // chunk 0's expand; later chunks' expands run one chunk ahead. It
      // takes the buffer the previous item's last chunk did not use: every
      // warpgroup has passed a barrier since it last read that one
      mbar_wait(w_full(ws), wph);
      if (p.expand) {
        ebuf ^= 1;
        expand_blocks(wg, stage_addr(ws), stage_ptr(ws), e_ptr(ebuf));
        named_bar_sync(1, nthreads);  // the chunk is read across warpgroups
      }

      // depthwise 3x3 + ReLU6 of chunk c (weights in w_s), f32 sums rounded
      // to bf16 straight into the A fragments of the project wgmma. In k16
      // step ks a thread holds columns 2t, 2t+1, 2t+8, 2t+9 of rows g, g+8;
      // the packed project weights order each step's 16 channels so that
      // these four are channels 16ks + 4t .. 16ks + 4t + 3, one 8-byte read
      // of the expanded chunk (or, without expand, of the input tile)
      auto depthwise = [&](uint32_t (&a)[KS][4], int c, int cval, const unsigned char* w_s) {
        const float* wd_s = reinterpret_cast<const float*>(w_s + p.wd_off);
        const float* bd_s = reinterpret_cast<const float*>(w_s + p.bd_off);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if (16 * ks >= cval) {  // padding channels only: zero, no work
            a[ks][0] = a[ks][1] = a[ks][2] = a[ks][3] = 0;
            continue;
          }
          const int j = 16 * ks + 4 * t4;
          const bf16* src;  // channels j..j+3 of halo pixel r at src + r * rstride
          int rstride;
          if (p.expand) {
            src = e_ptr(ebuf) + j;
            rstride = es(S);
          } else {
            const int ch = c * CH + j;
            src = x_s + (ch / 8) * p.pinp * 8 + ch % 8;
            rstride = 8;
          }
          const float4 b = *reinterpret_cast<const float4*>(bd_s + j);
          float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            float4 w[3];
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
              w[dx] = *reinterpret_cast<const float4*>(wd_s + (dy * 3 + dx) * CH + j);
#pragma unroll
            for (int dx = 0; dx < 3 + S; ++dx) {  // both windows' columns of this row
              float e[4];
              load_bf16x4(src + (hb + dy * win + dx) * rstride, e);
              if (dx < 3) fma4(s0, e, w[dx]);
              if (dx >= S) fma4(s1, e, w[dx - S]);
            }
          }
          a[ks][0] = relu6_bf16x2(s0[0] + b.x, s0[1] + b.y);
          a[ks][1] = relu6_bf16x2(s1[0] + b.x, s1[1] + b.y);
          a[ks][2] = relu6_bf16x2(s0[2] + b.z, s0[3] + b.w);
          a[ks][3] = relu6_bf16x2(s1[2] + b.z, s1[3] + b.w);
        }
      };
      // project partial sums, issued: acc[nb] += A . wp chunk[:, 24nb : 24nb+24]
      auto project_issue = [&](const uint32_t (&a)[KS][4], int cval, uint32_t wa) {
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            if (nb < nbr && 16 * ks < cval)
              wgmma_m64n24_rs(acc[nb], a[ks],
                              gmma_desc(wa + p.wp_off + nb * 3 * 128 + 2 * ks * lbo_wp,
                                        lbo_wp, 128));
        wg_commit();
      };
      auto project_done = [&](uint32_t (&a)[KS][4]) {
        wg_wait0();
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) fence_regs(a[ks]);
      };

      for (int c = 0; c < p.nchunks; ++c) {
        const int cval = min(CH, p.Ce - c * CH);  // real channels in this chunk (% 8 == 0)
        mbar_wait(w_full(ws), wph);  // (already passed if the expand ran ahead)
        const unsigned char* w_s = stage_ptr(ws);
        uint32_t a[KS][4];
        if (p.expand && c + 1 < p.nchunks) {
          // the next chunk's first expand block runs on the tensor cores
          // while this chunk's depthwise runs on the CUDA cores, and its
          // epilogue while this chunk's project runs
          const int ws_n = ws + 1 == p.wst ? 0 : ws + 1;
          mbar_wait(w_full(ws_n), ws_n == 0 ? wph ^ 1 : wph);
          expand_issue(wg, stage_addr(ws_n));
          depthwise(a, c, cval, w_s);
          project_issue(a, cval, stage_addr(ws));
          wg_wait1();  // the expand; the project's group is the newer one
          expand_store(wg, stage_ptr(ws_n), e_ptr(ebuf ^ 1));
          expand_blocks(wg + p.nc, stage_addr(ws_n), stage_ptr(ws_n), e_ptr(ebuf ^ 1));
          project_done(a);
          if (lane == 0) mbar_arrive(w_empty(ws));  // this warp is done with the stage
          named_bar_sync(1, nthreads);  // the next chunk is read across warpgroups
          ebuf ^= 1;
        } else {
          depthwise(a, c, cval, w_s);
          project_issue(a, cval, stage_addr(ws));
          project_done(a);
          if (lane == 0) mbar_arrive(w_empty(ws));
        }
        if (++ws == p.wst) { ws = 0; wph ^= 1; }
      }

      // epilogue: + bias [+ residual], round, store the pixels inside the map
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // accumulator row g + 8r: pixel q0 + r
        const int q = q0 + r;
        if (q >= pout) continue;
        const int qy = q / p.tw, qx = q % p.tw;
        const int oy = oy0 + qy, ox = ox0 + qx;
        if (oy >= Ho || ox >= Wo) continue;
        bf16* o = p.out + ((size_t(img) * Ho + oy) * Wo + ox) * p.Cout;
        const int pres = (qy + 1) * win + qx + 1;  // the same pixel in the halo tile
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          if (nb >= nbr) continue;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const int co = NBW * nb + 8 * i + 2 * t4;
            if (co >= p.Cout) continue;
            float v0 = acc[nb][4 * i + 2 * r] + __ldg(p.bp + co);
            float v1 = acc[nb][4 * i + 2 * r + 1] + __ldg(p.bp + co + 1);
            if (S == 1 && p.residual) {
              const float2 xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  x_s + ((co / 8) * p.pinp + pres) * 8 + co % 8));
              v0 += xr.x;
              v1 += xr.y;
            }
            *reinterpret_cast<uint32_t*>(o + co) = pack_bf16x2(v0, v1);
          }
        }
      }
      if (lane == 0) mbar_arrive(x_empty(xs));
      if (++xs == p.xst) { xs = 0; xph ^= 1; }
    }
  }
}

// Derived geometry and shared-memory layout of a bf16 launch; the same
// formulas as ops/mbconv.py::kernel_layout, which chose the plan.
void h_layout(HParams& p, int stride) {
  p.kpad = round_up(p.Cin, 16);
  p.coutp = round_up(p.Cout, NBW);
  p.hin = (p.th - 1) * stride + 3;
  p.win = (p.tw - 1) * stride + 3;
  p.pin = p.hin * p.win;
  p.pinp = round_up(p.pin, 64);
  p.x_bytes = uint32_t(p.kpad) * p.pinp * 2;
  p.wp_off = p.expand ? uint32_t(CH) * p.kpad * 2 : 0;  // expand weights [kpad/8][CH/8][8][8]
  p.wd_off = p.wp_off + uint32_t(p.coutp) * CH * 2;     // project weights [CH/8][coutp/8][8][8]
  p.be_off = p.wd_off + 9 * CH * 4;                     // depthwise weights [9][CH], float32
  p.bd_off = p.be_off + CH * 4;                         // biases, float32
  p.chunk_bytes = p.bd_off + CH * 4;
  p.w_stride = round_up(int(p.chunk_bytes), 128);
  p.e_bytes = round_up(p.pin * es(stride) * 2, 128);
  p.x_off = BAR_BYTES;
  p.w_off = p.x_off + p.xst * p.x_bytes;
  p.e_off = p.w_off + p.wst * p.w_stride;
  p.smem = p.e_off + 2 * p.e_bytes + 128;  // + room to align the base to 128 bytes
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda at link time).
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

template <int S, int NB>
cudaError_t launch_wgmma(const CUtensorMap& map, const HParams& p, int grid,
                         cudaStream_t stream) {
  static bool opted_in = false;  // the shared-memory limit is set once per kernel
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(mbconv_wgmma<S, NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  if (p.nc > max_nc(NB)) return cudaErrorInvalidValue;
  mbconv_wgmma<S, NB><<<grid, 128 * (p.nc + 1), p.smem, stream>>>(map, p);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_wgmma_nb(const CUtensorMap& map, const HParams& p, int grid,
                            cudaStream_t stream) {
  const int nbr = p.coutp / NBW;
  if (nbr <= 2) return launch_wgmma<S, 2>(map, p, grid, stream);
  if (nbr <= 5) return launch_wgmma<S, 5>(map, p, grid, stream);
  if (nbr <= 11) return launch_wgmma<S, 11>(map, p, grid, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// float32: x [B, H, W, Cin]; we [Cin, Ce] (unused when !expand); wd [3, 3, Ce];
// wp [Ce, Cout]; be [Ce], bd [Ce], bp [Cout]; out [B, H/stride, W/stride, Cout].
// Needs Cin % 4 == 0 and Cout % 8 == 0. Returns the CUDA error (0 on success).
int yrt_mbconv_f32(const void* x, const void* we, const void* be, const void* wd, const void* bd,
                   const void* wp, const void* bp, void* out, int B, int H, int W, int Cin,
                   int Ce, int Cout, int stride, int expand, int residual, void* stream) {
  if (Cin % 4 || Cout % 8 || (stride != 1 && stride != 2) ||
      (stride == 2 && (H % 2 || W % 2)) || (residual && (stride != 1 || Cin != Cout)) ||
      (!expand && Ce != Cin))
    return int(cudaErrorInvalidValue);
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      stride == 1 ? launch_f32<1>(f(x), f(we), f(be), f(wd), f(bd), f(wp), f(bp),
                                  static_cast<float*>(out), B, H, W, Cin, Ce, Cout, expand,
                                  residual, s)
                  : launch_f32<2>(f(x), f(we), f(be), f(wd), f(bd), f(wp), f(bp),
                                  static_cast<float*>(out), B, H, W, Cin, Ce, Cout, expand,
                                  residual, s);
  return int(e);
}

// bfloat16: x [B, H, W, Cin]; w the packed weights of ops/mbconv.py::
// pack_mbconv (nchunks chunks); bp [Cout] float32; out [B, H/stride,
// W/stride, Cout]. The tile plan (th x tw output pixels, nc consumer
// warpgroups, xst input and wst weight stages, a persistent grid of
// `grid` CTAs, `smem` bytes) comes from ops/mbconv.py::plan_tile; a plan
// this file would lay out differently is refused. Needs Cin % 8 == 0,
// Cout % 8 == 0 and x 16-byte aligned. Returns the CUDA error (0 on success).
int yrt_mbconv_bf16(const void* x, const void* w, const void* bp, void* out, int B, int H, int W,
                    int Cin, int Ce, int Cout, int nchunks, int stride, int expand, int residual,
                    int th, int tw, int nc, int xst, int wst, int grid, int smem, void* stream) {
  if (Cin % 8 || Cout % 8 || (stride != 1 && stride != 2) ||
      (stride == 2 && (H % 2 || W % 2)) || (residual && (stride != 1 || Cin != Cout)) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 || th < 1 ||
      tw < 2 || tw % 2 || nc < 1 || nc > MAX_NC || th * tw > 64 * nc || xst < 1 ||
      xst > MAX_STAGES || wst < 1 || wst > MAX_STAGES || grid < 1 || Ce % 8 ||
      nchunks != (Ce + CH - 1) / CH || (!expand && Ce != Cin))
    return int(cudaErrorInvalidValue);
  HParams p;
  p.w = static_cast<const unsigned char*>(w);
  p.bp = static_cast<const float*>(bp);
  p.out = static_cast<bf16*>(out);
  p.H = H; p.W = W; p.Cin = Cin; p.Ce = Ce; p.Cout = Cout; p.nchunks = nchunks;
  p.expand = expand; p.residual = residual;
  p.th = th; p.tw = tw; p.nc = nc; p.xst = xst; p.wst = wst;
  const int Ho = H / stride, Wo = W / stride;
  p.tiles_w = (Wo + tw - 1) / tw;
  p.items_per_image = p.tiles_w * ((Ho + th - 1) / th);
  p.items = B * p.items_per_image;
  h_layout(p, stride);
  if (int(p.smem) != smem || p.smem > SMEM_LIMIT || p.win > 256 || p.hin > 256)
    return int(cudaErrorInvalidValue);

  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[4] = {cuuint64_t(Cin), cuuint64_t(W), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(Cin) * 2, cuuint64_t(W) * Cin * 2,
                                 cuuint64_t(H) * W * Cin * 2};
  const cuuint32_t box[4] = {8, cuuint32_t(p.win), cuuint32_t(p.hin), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(stride == 1 ? launch_wgmma_nb<1>(map, p, grid, s)
                         : launch_wgmma_nb<2>(map, p, grid, s));
}

const char* yrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
