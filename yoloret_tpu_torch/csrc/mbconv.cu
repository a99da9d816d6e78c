// Fused inverted-residual (MBConv) block for Hopper, NHWC, BN folded:
//   expand 1x1 + ReLU6 -> depthwise 3x3 "SAME" + ReLU6 -> project 1x1
//   [+ residual], stride 1 or 2, with or without the expand conv.
//
// Replaces the TPU kernels yoloret_tpu/ops/mbconv_pallas.py::_kernel_s1 /
// _kernel_s2 (fused_mbconv) and yoloret_tpu/ops/mbconv_pallas2.py::
// _cp_kernel (fused_mbconv2_cp). Python side: ops/mbconv.py.
//
// What bounds it: device-memory bytes. Unfused, each block writes and
// re-reads its 6x-expanded tensor (160x160x96 bf16 = 4.9 MB per image at
// block 1); fused, a block moves only its input and output. Design: one
// thread block per (image, tile of output pixels). The input tile and its
// halo are loaded once into shared memory; the expanded channels are
// walked in chunks of 32 -- expand into shared memory (positions that are
// image padding are zeroed after the expand, since "SAME" pads the
// depthwise input, not the block input), depthwise into shared memory,
// and the project partial sums accumulate in registers. The expanded
// tensor never reaches device memory. Values are rounded to the input
// type where the JAX kernel rounds (after the expand, after the
// depthwise, at the output); sums are float32.
//
// bfloat16 (the serving path) runs both 1x1 convs on the tensor cores
// with mma.sync m16n8k16 (bf16 in, f32 accumulate): each warp owns 16-row
// slabs of the expand GEMM [pixels x Cin] . [Cin x 32] and a fixed set of
// 16x8 tiles of the project GEMM [pixels x 32] . [32 x Cout], whose
// accumulators stay in registers across all chunks. float32 (kept for
// checks against the plain version) runs the same steps as fp32 FMAs on
// the CUDA cores, register-blocked (an expand thread computes 4 pixels x
// 1 channel from 4-wide loads, a project thread owns rq pixels x 8
// channels). The depthwise runs on the CUDA cores in both. The tile shape
// is chosen per call (choose_tile) to waste the least work on the halo
// and on a map's ragged edge. Next steps: wgmma and TMA loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int WARPS = NT / 32;
constexpr int CH = 32;        // expanded channels per chunk
constexpr int ES = CH + 8;    // f32 row stride of the expanded chunk (no bank conflicts)
constexpr int DS = CH + 1;    // f32 row stride of the depthwise chunk (no bank conflicts)
constexpr int DSB = CH + 8;   // bf16 row stride of the depthwise chunk and project weights
constexpr int MAX_TILE = 16;  // output tile side limit
constexpr int MAX_RQ = 4;     // float32 path: project pixels per thread
constexpr int MAX_MT = 8;     // bfloat16 path: project 16x8 tiles per warp

template <typename T> constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// Round to the storage type and back to float.
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }
__device__ __forceinline__ float relu6f(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A . B for one 16x16 (row) by 16x8 (col) bf16 tile pair, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [m0, m0+16) and columns [k0, k0+16) of a row-major
// bf16 matrix with row stride ld (elements).
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* base, int ld,
                                       int m0, int k0, int lane) {
  const __nv_bfloat16* p = base + (m0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

__host__ __device__ constexpr size_t align16(size_t v) { return (v + 15) & ~size_t(15); }
__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

struct Layout {  // tile geometry and byte offsets into dynamic shared memory
  int win, pin, pinr, pout, poutp, xs, kpad;
  size_t e, d, we, wp, wd, total;
};

// mma: bf16 path (rows padded to 16, padded row strides); else float32.
__host__ __device__ inline Layout layout(bool mma, int stride, int th, int tw, int rq, int cin,
                                         int cout) {
  Layout l;
  l.win = (tw - 1) * stride + 3;
  l.pin = ((th - 1) * stride + 3) * l.win;
  l.pout = th * tw;
  l.kpad = round_up(cin, 16);
  if (mma) {
    l.pinr = round_up(l.pin, 16);
    l.poutp = round_up(l.pout, 16);
    l.xs = l.kpad + 8;
    l.e = align16(size_t(l.pinr) * l.xs * 2);             // x tile [PINR][XS], bf16
    l.d = l.e + align16(size_t(l.pin) * ES * 4);          // expanded chunk [PIN][ES], f32
    l.we = l.d + align16(size_t(l.poutp) * DSB * 2);      // depthwise chunk [POUTP][DSB], bf16
    l.wp = l.we + align16(size_t(CH) * l.xs * 2);         // expand weights [CH][XS], bf16
    l.wd = l.wp + align16(size_t(cout) * DSB * 2);        // project weights [Cout][DSB], bf16
  } else {
    l.pinr = round_up(l.pin, 4);
    l.poutp = round_up(l.pout, rq);
    l.xs = cin;
    l.e = align16(size_t(l.pinr) * cin * 4);              // x tile [PINR][Cin], f32
    l.d = l.e + align16(size_t(l.pin) * ES * 4);          // expanded chunk [PIN][ES], f32
    l.we = l.d + align16(size_t(l.poutp) * DS * 4);       // depthwise chunk [POUTP][DS], f32
    l.wp = l.we + align16(size_t(cin) * CH * 4);          // expand weights [Cin][CH], f32
    l.wd = l.wp + align16(size_t(CH) * cout * 4);         // project weights [CH][Cout], f32
  }
  l.total = l.wd + align16(size_t(9) * CH * 4);           // depthwise weights [9][CH], f32
  return l;
}

template <typename T, int S>
__global__ void __launch_bounds__(NT) mbconv_kernel(
    const T* __restrict__ x, const T* __restrict__ we, const float* __restrict__ be,
    const T* __restrict__ wd, const float* __restrict__ bd, const T* __restrict__ wp,
    const float* __restrict__ bp, T* __restrict__ out, int H, int W, int Cin, int Ce,
    int Cout, int expand, int residual, int th, int tw, int rq, int tiles_w) {
  constexpr bool MMA = kMma<T>;
  constexpr int PAD = S == 1 ? 1 : 0;  // "SAME": (1, 1) at stride 1, (0, 1) at stride 2
  const Layout L = layout(MMA, S, th, tw, rq, Cin, Cout);
  const int win = L.win, PIN = L.pin, XS = L.xs;
  const int Ho = H / S, Wo = W / S;
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_w) * th, ox0 = (blockIdx.x % tiles_w) * tw;
  const int iy0 = oy0 * S - PAD, ix0 = ox0 * S - PAD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(16) unsigned char smem[];
  T* x_s = reinterpret_cast<T*>(smem);
  float* e_s = reinterpret_cast<float*>(smem + L.e);
  float* wd_s = reinterpret_cast<float*>(smem + L.wd);

  // input tile with its halo, 16 bytes a load (Cin and XS are multiples of
  // V elements); image padding, padded rows and columns are zero
  constexpr int V = 16 / sizeof(T);
  const T* xb = x + size_t(b) * H * W * Cin;
  for (int i = tid; i < L.pinr * (XS / V); i += NT) {
    const int p = i / (XS / V), c = (i - p * (XS / V)) * V;
    const int gy = iy0 + p / win, gx = ix0 + p % win;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (c < Cin && p < PIN && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = *reinterpret_cast<const uint4*>(xb + (size_t(gy) * W + gx) * Cin + c);
    *reinterpret_cast<uint4*>(x_s + p * XS + c) = v;
  }

  // project accumulators: float32 path, rq pixels x 8 channels per thread;
  // bfloat16 path, up to MAX_MT 16x8 tiles per warp (4 floats a lane each)
  const int cgs = Cout / 8;
  const int n_ptiles = (L.poutp / 16) * cgs;
  const bool owner = MMA || tid < (L.poutp / rq) * cgs;
  const int q0 = (tid / cgs) * rq, co0 = (tid % cgs) * 8;
  float acc[MAX_MT][4];
#pragma unroll
  for (int r = 0; r < MAX_MT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  float* acc_f = &acc[0][0];  // float32 path: acc_f[r * 8 + c], r < MAX_RQ

  for (int c0 = 0; c0 < Ce; c0 += CH) {
    const int nc = min(CH, Ce - c0);
    // stage this chunk's weights
    if constexpr (MMA) {
      __nv_bfloat16* we_s = reinterpret_cast<__nv_bfloat16*>(smem + L.we);
      __nv_bfloat16* wp_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wp);
      if (expand) {
        for (int i = tid; i < CH * XS; i += NT) {  // we_s[n][k] = we[k][c0 + n]
          const int k = i / CH, n = i - k * CH;
          we_s[n * XS + k] = (n < nc && k < Cin) ? we[size_t(k) * Ce + c0 + n] : from_f<T>(0.f);
        }
      }
      for (int i = tid; i < CH * Cout; i += NT) {  // wp_s[co][j] = wp[c0 + j][co]
        const int j = i / Cout, co = i - j * Cout;
        wp_s[co * DSB + j] = j < nc ? wp[size_t(c0 + j) * Cout + co] : from_f<T>(0.f);
      }
    } else {
      float* we_s = reinterpret_cast<float*>(smem + L.we);
      float* wp_s = reinterpret_cast<float*>(smem + L.wp);
      if (expand) {
        for (int i = tid; i < Cin * CH; i += NT) {
          const int k = i / CH, j = i - k * CH;
          we_s[i] = j < nc ? to_f(we[size_t(k) * Ce + c0 + j]) : 0.f;
        }
      }
      for (int i = tid; i < CH * Cout; i += NT) {
        const int j = i / Cout, co = i - j * Cout;
        wp_s[i] = j < nc ? to_f(wp[size_t(c0 + j) * Cout + co]) : 0.f;
      }
    }
    for (int i = tid; i < 9 * CH; i += NT) {
      const int tap = i / CH, j = i - tap * CH;
      wd_s[i] = j < nc ? to_f(wd[tap * Ce + c0 + j]) : 0.f;
    }
    __syncthreads();

    // expand + ReLU6 over the halo tile into e_s; image padding stays zero
    auto inside = [&](int p) {
      const int gy = iy0 + p / win, gx = ix0 + p % win;
      return gy >= 0 && gy < H && gx >= 0 && gx < W;
    };
    auto value = [&](int p, int j, float a) {  // expanded value at a pixel inside the image
      if (j >= nc) return 0.f;
      return expand ? rnd<T>(relu6f(a + be[c0 + j])) : to_f(x_s[p * XS + c0 + j]);
    };
    if constexpr (MMA) {
      const __nv_bfloat16* we_s = reinterpret_cast<const __nv_bfloat16*>(smem + L.we);
      for (int m0 = warp * 16; m0 < L.pinr; m0 += WARPS * 16) {
        float d[4][4] = {};
        if (expand) {
          for (int k0 = 0; k0 < L.kpad; k0 += 16) {
            uint32_t a[4];
            load_a(a, x_s, XS, m0, k0, lane);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const __nv_bfloat16* bq = we_s + (nt * 8 + (lane >> 2)) * XS + k0 + 2 * (lane & 3);
              mma_bf16(d[nt], a, ld32(bq), ld32(bq + 8));
            }
          }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {  // d[nt][2hr + e]: row g + 8hr, column 2t + e
          const int p = m0 + (lane >> 2) + 8 * hr;
          if (p >= PIN) continue;
          const bool in = inside(p);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int j = nt * 8 + 2 * (lane & 3);
            float2 v = make_float2(0.f, 0.f);
            if (in) v = make_float2(value(p, j, d[nt][2 * hr]), value(p, j + 1, d[nt][2 * hr + 1]));
            *reinterpret_cast<float2*>(e_s + p * ES + j) = v;
          }
        }
      }
    } else {
      const float* we_s = reinterpret_cast<const float*>(smem + L.we);
      for (int i = tid; i < (L.pinr / 4) * CH; i += NT) {
        const int p0 = (i / CH) * 4, j = i % CH;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        if (j < nc && expand) {
          for (int k = 0; k < Cin; k += 4) {
            const float w0 = we_s[k * CH + j], w1 = we_s[(k + 1) * CH + j];
            const float w2 = we_s[(k + 2) * CH + j], w3 = we_s[(k + 3) * CH + j];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              float xv[4];
              load4(reinterpret_cast<const float*>(x_s) + (p0 + r) * Cin + k, xv);
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
          if (p < PIN) e_s[p * ES + j] = inside(p) ? value(p, j, a[r]) : 0.f;
        }
      }
    }
    __syncthreads();

    // depthwise 3x3 + ReLU6 at the output pixels; padded rows are zero
    for (int i = tid; i < L.poutp * CH; i += NT) {
      const int q = i / CH, j = i - q * CH;
      float v = 0.f;
      if (q < L.pout && j < nc) {
        const int oy = q / tw, ox = q - oy * tw;
        float a = 0.f;
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj)
            a += e_s[((oy * S + di) * win + ox * S + dj) * ES + j] *
                 wd_s[(di * 3 + dj) * CH + j];
        v = rnd<T>(relu6f(a + bd[c0 + j]));
      }
      if constexpr (MMA)
        reinterpret_cast<__nv_bfloat16*>(smem + L.d)[q * DSB + j] = from_f<T>(v);
      else
        reinterpret_cast<float*>(smem + L.d)[q * DS + j] = v;
    }
    __syncthreads();

    // project partial sums
    if constexpr (MMA) {
      const __nv_bfloat16* d_s = reinterpret_cast<const __nv_bfloat16*>(smem + L.d);
      const __nv_bfloat16* wp_s = reinterpret_cast<const __nv_bfloat16*>(smem + L.wp);
#pragma unroll
      for (int t = 0; t < MAX_MT; ++t) {
        const int tile = warp + WARPS * t;
        if (tile < n_ptiles) {
          const int m0 = (tile / cgs) * 16, n0 = (tile % cgs) * 8;
#pragma unroll
          for (int k0 = 0; k0 < CH; k0 += 16) {
            uint32_t a[4];
            load_a(a, d_s, DSB, m0, k0, lane);
            const __nv_bfloat16* bq = wp_s + (n0 + (lane >> 2)) * DSB + k0 + 2 * (lane & 3);
            mma_bf16(acc[t], a, ld32(bq), ld32(bq + 8));
          }
        }
      }
    } else if (owner) {
      const float* d_s = reinterpret_cast<const float*>(smem + L.d);
      const float* wp_s = reinterpret_cast<const float*>(smem + L.wp);
      for (int j = 0; j < CH; ++j) {
        float w[8];
        load4(wp_s + j * Cout + co0, w);
        load4(wp_s + j * Cout + co0 + 4, w + 4);
#pragma unroll
        for (int r = 0; r < MAX_RQ; ++r) {
          if (r < rq) {
            const float dv = d_s[(q0 + r) * DS + j];
#pragma unroll
            for (int c = 0; c < 8; ++c) acc_f[r * 8 + c] += dv * w[c];
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the weights and both tiles
  }

  // epilogue: + bias [+ residual], round, store the pixels inside the map,
  // two adjacent channels a store
  T* ob = out + size_t(b) * Ho * Wo * Cout;
  auto store2 = [&](int q, int co, float v0, float v1) {
    if (q >= L.pout) return;
    const int qy = q / tw, qx = q - qy * tw;
    const int oy = oy0 + qy, ox = ox0 + qx;
    if (oy >= Ho || ox >= Wo) return;
    v0 += bp[co];
    v1 += bp[co + 1];
    if (S == 1 && residual) {
      const T* xr = x_s + ((qy + 1) * win + qx + 1) * XS + co;
      v0 += to_f(xr[0]);
      v1 += to_f(xr[1]);
    }
    T* o = ob + (size_t(oy) * Wo + ox) * Cout + co;
    if constexpr (MMA)
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
    else
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  };
  if constexpr (MMA) {
#pragma unroll
    for (int t = 0; t < MAX_MT; ++t) {
      const int tile = warp + WARPS * t;
      if (tile < n_ptiles) {
        const int m0 = (tile / cgs) * 16, n0 = (tile % cgs) * 8;
        const int q = m0 + (lane >> 2), co = n0 + 2 * (lane & 3);
        store2(q, co, acc[t][0], acc[t][1]);
        store2(q + 8, co, acc[t][2], acc[t][3]);
      }
    }
  } else if (owner) {
#pragma unroll
    for (int r = 0; r < MAX_RQ; ++r)
      if (r < rq)
#pragma unroll
        for (int c = 0; c < 8; c += 2) store2(q0 + r, co0 + c, acc_f[r * 8 + c], acc_f[r * 8 + c + 1]);
  }
}

struct Tile {
  int th, tw, rq;
};

// The output tile with the lowest modelled cost per image: tiles x (the
// expand, depthwise and project steps of one tile + weight staging).
// Steps are counted per thread (float32) or per warp (bfloat16, one
// mma.sync counted as 4). A tile must fit the project accumulators
// (MAX_RQ x 8 per thread, or MAX_MT tiles per warp) and shared memory,
// for two resident blocks when possible.
bool choose_tile(bool mma, int Ho, int Wo, int stride, int Cin, int Cout, Tile* best) {
  double best_cost = 0;
  bool found = false;
  const size_t limits[2] = {113 * 1024, 227 * 1024};
  for (size_t limit : limits) {
    for (int th = 1; th <= MAX_TILE && th <= Ho; ++th) {
      for (int tw = 1; tw <= MAX_TILE && tw <= Wo; ++tw) {
        int rq = 1;
        if (mma) {
          if ((round_up(th * tw, 16) / 16) * (Cout / 8) > WARPS * MAX_MT) continue;
        } else {
          while (rq <= MAX_RQ && (round_up(th * tw, rq) / rq) * (Cout / 8) > NT) rq *= 2;
          if (rq > MAX_RQ) continue;
        }
        const Layout l = layout(mma, stride, th, tw, rq, Cin, Cout);
        if (l.total > limit) continue;
        const double tiles = double((Ho + th - 1) / th) * ((Wo + tw - 1) / tw);
        const double depthwise = double((l.poutp * CH + NT - 1) / NT) * 9;
        const double staging = 4.0 * double((l.kpad + Cout) * CH) / NT;
        double expand, project;
        if (mma) {
          const int mt = l.pinr / 16, pt = (l.poutp / 16) * (Cout / 8);
          expand = double((mt + WARPS - 1) / WARPS) * (l.kpad / 16) * 4 * 4 + 8.0 * l.pin * CH / NT;
          project = double((pt + WARPS - 1) / WARPS) * 2 * 4;
        } else {
          expand = double((l.pinr / 4 * CH + NT - 1) / NT) * 4 * Cin;
          project = double(CH) * rq * 8;
        }
        const double cost = tiles * (expand + depthwise + project + staging);
        if (!found || cost < best_cost) {
          best_cost = cost;
          *best = Tile{th, tw, rq};
          found = true;
        }
      }
    }
    if (found) return true;
  }
  return false;
}

template <typename T, int S>
cudaError_t launch(const void* x, const void* we, const void* be, const void* wd,
                   const void* bd, const void* wp, const void* bp, void* out, int B, int H,
                   int W, int Cin, int Ce, int Cout, int expand, int residual,
                   cudaStream_t stream) {
  const int Ho = H / S, Wo = W / S;
  Tile t;
  if (!choose_tile(kMma<T>, Ho, Wo, S, Cin, Cout, &t)) return cudaErrorInvalidValue;
  const int tiles_w = (Wo + t.tw - 1) / t.tw, tiles_h = (Ho + t.th - 1) / t.th;
  const size_t smem = layout(kMma<T>, S, t.th, t.tw, t.rq, Cin, Cout).total;
  auto kern = mbconv_kernel<T, S>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  kern<<<dim3(tiles_w * tiles_h, B), NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(we), static_cast<const float*>(be),
      static_cast<const T*>(wd), static_cast<const float*>(bd), static_cast<const T*>(wp),
      static_cast<const float*>(bp), static_cast<T*>(out), H, W, Cin, Ce, Cout, expand,
      residual, t.th, t.tw, t.rq, tiles_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The tile the kernel would use for these sizes: returns th * 10000 +
// tw * 100 + rq, or 0 if none fits.
int yrt_mbconv_tile(int Ho, int Wo, int stride, int Cin, int Cout, int bf16) {
  Tile t;
  if (!choose_tile(bf16 != 0, Ho, Wo, stride, Cin, Cout, &t)) return 0;
  return t.th * 10000 + t.tw * 100 + t.rq;
}

// x [B, H, W, Cin]; we [Cin, Ce] (unused when !expand); wd [3, 3, Ce];
// wp [Ce, Cout] in the type of x (float32, or bfloat16 when bf16 != 0);
// be [Ce], bd [Ce], bp [Cout] float32; out [B, H/stride, W/stride, Cout].
// Needs Cout % 8 == 0 and Cin % 8 == 0 (bfloat16) or Cin % 4 == 0
// (float32), so the input tile loads 16 bytes at a time. Returns the CUDA
// error of the launch (0 on success).
int yrt_mbconv(const void* x, const void* we, const void* be, const void* wd,
               const void* bd, const void* wp, const void* bp, void* out, int B, int H,
               int W, int Cin, int Ce, int Cout, int stride, int expand, int residual,
               int bf16, void* stream) {
  if (Cin % (bf16 ? 8 : 4) || Cout % 8 || (stride != 1 && stride != 2) ||
      (stride == 2 && (H % 2 || W % 2)) || (residual && (stride != 1 || Cin != Cout)) ||
      (!expand && Ce != Cin))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bf16) {
    e = stride == 1 ? launch<__nv_bfloat16, 1>(x, we, be, wd, bd, wp, bp, out, B, H, W, Cin,
                                               Ce, Cout, expand, residual, s)
                    : launch<__nv_bfloat16, 2>(x, we, be, wd, bd, wp, bp, out, B, H, W, Cin,
                                               Ce, Cout, expand, residual, s);
  } else {
    e = stride == 1 ? launch<float, 1>(x, we, be, wd, bd, wp, bp, out, B, H, W, Cin, Ce,
                                       Cout, expand, residual, s)
                    : launch<float, 2>(x, we, be, wd, bd, wp, bp, out, B, H, W, Cin, Ce,
                                       Cout, expand, residual, s);
  }
  return int(e);
}

const char* yrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
