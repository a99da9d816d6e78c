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
// Wide blocks (Cout 121-264: MobileNetV2 x1.4's blocks 10-15, x1.0's
// 13-15). Each consumer thread holds its 64-row block's project sums,
// 12 floats per 24 output channels. The first version sized that array
// for 11 blocks whatever the launch, so its Cout 136 and 224 spilled ~2.6
// KB a thread at 160 registers and ptxas serialised every wgmma (C7511),
// and its 7x7 maps ran one warpgroup an SM. Now:
// - an instance per accumulator count from 6 to 11 holds exactly the
//   launch's blocks (Cout 136: 6, 160: 7, 224: 10); up to 6 blocks three
//   consumer warpgroups fit at 160 registers, past that two at 232. The
//   register file holds no more (six blocks in four warpgroups at 112
//   spill), so a 14x14 map takes two items an image, not one;
// - the chunks of a tile may be split among ks groups of nc / ks
//   warpgroups: group g sums chunks g, g + ks, ... of the whole tile into
//   its own project sums, expanding each chunk into a buffer of its own;
//   then groups 1..ks-1 write their sums over the weight ring (whose
//   stages hold the item's last chunks, released only after this) and
//   group 0 adds them in group order and stores. No atomics: the same
//   bits on every launch. A 7x7 map is one 7x8 tile an image with its 17
//   or 28 chunks split between two warpgroups, so both are busy;
// - no instance spills and ptxas serialises no wgmma nor injects an
//   arrive (notes C7510-C7520): the producer keeps 32 registers (at 24 it
//   spilled one); the warpgroup index comes through a shuffle, so loops
//   bounded by it are not divergent paths (the chunk groups' loops were,
//   and their wgmmas serialised, C7520); each expand k16 step is fenced
//   and committed on its own, and the project's chain is unrolled for the
//   launch's block count between its fence and commit.
// plan_tile's wide model (ops/mbconv.py::wide_cost, fitted to every
// plan's time at the six wide block shapes) chooses tile, warpgroups and
// groups. tools/mbconv_ablation.py --variants undoes these choices one
// at a time.
//
// Values are rounded to bf16 where the JAX kernel rounds (after the
// expand, after the depthwise, at the output); sums are float32.
//
// float32, mbconv_f32: the port's exact mode, the float32 evaluation path
// (the self-check's verdict, the accuracy gate, the top-k study, every
// --no-bf16 run). The same steps as fp32 FMAs with fp32 sums on the CUDA
// cores (TF32 would keep ~3 digits), register-blocked: the expand px (1, 2
// or 4) pixels x 4 channels a thread, the depthwise a lane per channel, the
// project rq pixels x 8 channels. Float32 doubles the bytes and runs at
// 1/15 of the bf16 tensor cores' rate, so at b128 its blocks are bound by
// operations (in practice by the shared-memory wavefronts of the 16-byte
// operand loads); at the learn phase's b8 a block is a few microseconds of
// work and what bounds it is latency. The design, against the first
// version's (commit 63bfe4e):
// - weights packed once per model (ops/mbconv.py::pack_mbconv_f32), one
//   contiguous run per chunk of 32 expanded channels, staged by cp.async
//   into two-stage rings one pipeline step ahead, instead of scalar
//   gathers from device memory in every chunk;
// - a three-step software pipeline (expand of chunk i, depthwise of i - 1,
//   project of i - 2) with one barrier a step, instead of four a chunk;
// - the expand only over the halo pixels inside the image (a 3x3 map's
//   5x5 halo holds 9);
// - where (tile, image) pairs leave SMs idle, a thread-block cluster of up
//   to 8 CTAs splits each pair: each CTA runs the expand and depthwise of
//   a contiguous share of the chunks and keeps them in its shared memory;
//   after a cluster barrier each runs the project of a slice of Cout over
//   all chunks, reading the others' depthwise chunks through distributed
//   shared memory. Each output is summed over the chunks in order, as
//   without a cluster: no atomics, and the same bits under every plan and
//   on every run (the first version's bits; partial sums added across the
//   cluster would round otherwise). ops/mbconv.py::plan_tile_f32 chooses
//   the tile, the pixels per thread and the cluster, counting waves over
//   the card's SMs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float relu6f(float v) { return fminf(fmaxf(v, 0.f), 6.f); }
__host__ __device__ constexpr size_t align16(size_t v) { return (v + 15) & ~size_t(15); }
__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
constexpr int SMEM_LIMIT = 232448;  // 227 KB a block can use on sm_90
constexpr int MAX_DEVICES = 64;

// A kernel's dynamic shared-memory limit is set on one device: raise it to
// SMEM_LIMIT on the current device, once a device (`done` is the kernel's).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < MAX_DEVICES && done[dev])) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// float32: CUDA-core kernel, chunk-pipelined, clusters on small grids
// ---------------------------------------------------------------------------

constexpr int F_NT = 256;         // threads per block
constexpr int F_CH = 32;          // expanded channels per chunk (a lane each in the depthwise)
constexpr int F_DS = F_CH + 1;    // row stride of the depthwise chunk (no bank conflicts)
constexpr int F_MAX_RQ = 4;       // project pixels per thread
constexpr int F_MAX_CLUSTER = 8;  // CTAs of a cluster (the portable limit)
constexpr int F_BG = 4;           // chunks a step of a cluster's project
constexpr int F_MAX_UNITS = 4;    // project units (1 pixel x 4 channels) a thread, with a cluster

// Tile geometry and shared-memory layout of a float32 launch; the same
// formulas as ops/mbconv.py::kernel_layout_f32, which chose the plan.
// Without a cluster: the input tile, two expanded chunks, two depthwise
// chunks and two stages of each weight part. With one: the input tile,
// this CTA's depthwise chunks (all of them, read by the whole cluster),
// two expanded chunks and the expand and depthwise rings; then the
// project's two stages of F_BG depthwise chunks and project-weight slices
// alias everything after the depthwise chunks.
struct FLayout {
  int win, hin, pin, pout, poutp;
  int xs;                      // row stride of the input tile, = 8 (mod 16) floats
  int e_part, d_part, p_part;  // floats of one packed chunk's parts
  int nloc, slice;             // with a cluster: chunks a CTA holds, project channels a CTA
  size_t dl, e, d, we, wd, wp, bd, bw, total;  // byte offsets
};

__host__ __device__ inline FLayout f_layout(int stride, int th, int tw, int rq, int cin, int cout,
                                            int expand, int cluster, int nchunks) {
  FLayout l;
  l.win = (tw - 1) * stride + 3;
  l.hin = (th - 1) * stride + 3;
  l.pin = l.hin * l.win;
  l.pout = th * tw;
  l.poutp = round_up(l.pout, rq);
  l.xs = cin + (24 - cin % 16) % 16;
  l.e_part = expand ? cin * F_CH + F_CH : 0;  // we [Cin][32], be [32]
  l.d_part = 9 * F_CH + F_CH;                 // wd [9][32], bd [32]
  l.p_part = F_CH * cout;                     // wp [32][Cout]
  l.nloc = (nchunks + cluster - 1) / cluster;
  l.slice = (cout / 8 + cluster - 1) / cluster * 8;
  const size_t x_end = align16(size_t(l.pin) * l.xs * 4);  // x tile [PIN][XS]
  if (cluster == 1) {
    l.dl = l.bd = l.bw = 0;
    l.e = x_end;                                           // expanded chunks 2 x [PIN][32]
    l.d = l.e + size_t(2) * l.pin * F_CH * 4;              // depthwise chunks 2 x [POUTP][DS]
    l.we = align16(l.d + size_t(2) * l.poutp * F_DS * 4);  // weight rings, two stages each
    l.wd = l.we + size_t(2) * l.e_part * 4;
    l.wp = l.wd + size_t(2) * l.d_part * 4;
    l.total = l.wp + size_t(2) * l.p_part * 4;
  } else {
    l.d = 0;
    l.dl = x_end;                                        // depthwise chunks nloc x [POUTP][32]
    l.e = l.dl + size_t(l.nloc) * l.poutp * F_CH * 4;    // expanded chunks 2 x [PIN][32]
    l.we = l.e + size_t(2) * l.pin * F_CH * 4;           // expand and depthwise rings
    l.wd = l.we + size_t(2) * l.e_part * 4;
    l.wp = l.wd + size_t(2) * l.d_part * 4;              // (no project ring)
    l.bd = l.e;                                          // project: 2 x F_BG x [POUT][32]
    l.bw = l.bd + size_t(2) * F_BG * l.pout * F_CH * 4;  // and 2 x F_BG x [32][slice]
    const size_t b_end = l.bw + size_t(2) * F_BG * F_CH * l.slice * 4;
    l.total = l.wp > b_end ? l.wp : b_end;
  }
  return l;
}

struct FParams {
  const float* x;
  const float* w;  // packed weights, nchunks x (e_part + d_part + p_part) floats
  const float* bp;
  float* out;
  int H, W, Cin, Cout, nchunks, expand, residual;
  int th, tw, rq, px, cluster, tiles_w;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// Four floats of the shared memory of CTA `rank` of this cluster, at the
// address `addr` has in this CTA.
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr, uint32_t rank) {
  uint32_t ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(ra) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(ra)
               : "memory");
  return v;
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ float4 relu6f4(float4 v) {
  return make_float4(relu6f(v.x), relu6f(v.y), relu6f(v.z), relu6f(v.w));
}
__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// One CTA: one (output tile, image), or with a cluster of `cluster` CTAs
// the expand and depthwise of chunks [rank * n / cluster, (rank + 1) * n /
// cluster) of it and the project of a slice of Cout over all n chunks.
// Every output is the same sum in the same order (chunks, then channels,
// ascending, one fmaf each) under every plan: a cluster changes which SM
// adds, never the bits.
template <int S>
__global__ void __launch_bounds__(F_NT, 2) mbconv_f32(const FParams p) {
  constexpr int PAD = S == 1 ? 1 : 0;  // "SAME": (1, 1) at stride 1, (0, 1) at stride 2
  const FLayout L = f_layout(S, p.th, p.tw, p.rq, p.Cin, p.Cout, p.expand, p.cluster, p.nchunks);
  const int win = L.win, XS = L.xs, Cin = p.Cin, Cout = p.Cout, R = p.cluster;
  const bool clustered = R > 1;
  const int Ho = p.H / S, Wo = p.W / S;
  const int b = blockIdx.y, tile = blockIdx.x / R;
  const int rank = clustered ? int(cluster_rank()) : 0;
  const int oy0 = (tile / p.tiles_w) * p.th, ox0 = (tile % p.tiles_w) * p.tw;
  const int iy0 = oy0 * S - PAD, ix0 = ox0 * S - PAD;
  // the halo pixels inside the image: a rectangle; the others are padding
  const int ry0 = max(0, -iy0), ry1 = min(L.hin, p.H - iy0);
  const int rx0 = max(0, -ix0), rx1 = min(win, p.W - ix0);
  const int rw = rx1 - rx0, npix = (ry1 - ry0) * rw;
  const int c_begin = rank * p.nchunks / R;
  const int nloc = (rank + 1) * p.nchunks / R - c_begin;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* x_s = reinterpret_cast<float*>(smem);
  float* e_s = reinterpret_cast<float*>(smem + L.e);
  float* d_s = reinterpret_cast<float*>(smem + (clustered ? L.dl : L.d));
  float* we_s = reinterpret_cast<float*>(smem + L.we);
  float* wd_s = reinterpret_cast<float*>(smem + L.wd);
  float* wp_s = reinterpret_cast<float*>(smem + L.wp);
  const int ebuf = L.pin * F_CH;
  // without a cluster two depthwise buffers [POUTP][DS]; with one, this
  // CTA's chunk i at i * dbuf, [POUTP][32]
  const int dstride = clustered ? F_CH : F_DS, dbuf = L.poutp * dstride;
  const size_t chunk = size_t(L.e_part) + L.d_part + L.p_part;
  const float* wg = p.w + size_t(c_begin) * chunk;  // this CTA's first chunk

  // chunk c's part (offset off, n floats) into dst, 16 bytes a thread a step
  auto stage = [&](float* dst, int c, int off, int n) {
    const float* src = wg + size_t(c) * chunk + off;
    for (int i = tid * 4; i < n; i += F_NT * 4) cp_async16(dst + i, src + i);
  };

  // both expanded buffers start at zero: halo pixels outside the image
  // are never written, so they stay the depthwise's zero padding
  for (int i = tid; i < 2 * ebuf / 4; i += F_NT)
    reinterpret_cast<float4*>(e_s)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // first copies: the input tile (the pixels inside the image) and the
  // first chunk's expand weights
  const float* xb = p.x + size_t(b) * p.H * p.W * Cin;
  const int cq = Cin / 4;
  for (int i = tid; i < npix * cq; i += F_NT) {
    const int n = i / cq, c = (i - n * cq) * 4;
    const int hy = ry0 + n / rw, hx = rx0 + n % rw;
    cp_async16(x_s + (hy * win + hx) * XS + c,
               xb + (size_t(iy0 + hy) * p.W + ix0 + hx) * Cin + c);
  }
  if (p.expand && nloc > 0) stage(we_s, 0, 0, L.e_part);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (p.expand && nloc > 1) stage(we_s + L.e_part, 1, 0, L.e_part);
  if (nloc > 0) stage(wd_s, 0, L.e_part, L.d_part);
  cp_async_commit();

  // expand + ReLU6 of local chunk c into e: a thread computes px (1, 2
  // or 4) pixels x 4 channels; a warp takes 4 pixel groups x the chunk's
  // 32 channels, and pixel r of group g is in-image pixel g + r * G, so a
  // warp's four x reads are neighbouring pixels (XS = 8 mod 16: distinct
  // banks)
  auto expand = [&](int c, const float* w_e, float* e) {
    const int G = (npix + p.px - 1) / p.px;
    for (int i = tid; i < G * 8; i += F_NT) {
      const int g = i >> 3, jq = (i & 7) * 4;
      int pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = g + r * G;
        pr[r] = r < p.px && n < npix ? (ry0 + n / rw) * win + rx0 + n % rw : -1;
      }
      if (p.expand) {
        float a[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) a[r][k] = 0.f;
        const float* xr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) xr[r] = x_s + (pr[r] >= 0 ? pr[r] : pr[0]) * XS;
        for (int k = 0; k < Cin; k += 4) {
          float4 w[4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            w[kk] = *reinterpret_cast<const float4*>(w_e + (k + kk) * F_CH + jq);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (r >= p.px) break;
            const float4 xv = *reinterpret_cast<const float4*>(xr[r] + k);
            const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              a[r][0] = fmaf(xk[kk], w[kk].x, a[r][0]);
              a[r][1] = fmaf(xk[kk], w[kk].y, a[r][1]);
              a[r][2] = fmaf(xk[kk], w[kk].z, a[r][2]);
              a[r][3] = fmaf(xk[kk], w[kk].w, a[r][3]);
            }
          }
        }
        const float4 be = *reinterpret_cast<const float4*>(w_e + Cin * F_CH + jq);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (pr[r] >= 0)
            *reinterpret_cast<float4*>(e + pr[r] * F_CH + jq) = relu6f4(
                make_float4(a[r][0] + be.x, a[r][1] + be.y, a[r][2] + be.z, a[r][3] + be.w));
      } else {  // no expand: the chunk's channels of the input (zero past Cin)
        const int ch = (c_begin + c) * F_CH + jq;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (pr[r] < 0) continue;
          float v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = ch + k < Cin ? x_s[pr[r] * XS + ch + k] : 0.f;
          *reinterpret_cast<float4*>(e + pr[r] * F_CH + jq) = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  };

  // depthwise 3x3 + ReLU6 at the output pixels; a lane per channel, its
  // nine weights and bias in registers; padded rows are zero
  auto depthwise = [&](const float* w_d, const float* e, float* d) {
    const int j = tid & (F_CH - 1);
    float wr[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wr[t] = w_d[t * F_CH + j];
    const float bias = w_d[9 * F_CH + j];
    for (int q = tid / F_CH; q < L.poutp; q += F_NT / F_CH) {
      float v = 0.f;
      if (q < L.pout) {
        const int oy = q / p.tw, ox = q - oy * p.tw;
        const float* er = e + (oy * S * win + ox * S) * F_CH + j;
        float a = 0.f;
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) a = fmaf(er[(di * win + dj) * F_CH], wr[di * 3 + dj], a);
        v = relu6f(a + bias);
      }
      d[q * dstride + j] = v;
    }
  };

  // project sums (no cluster): rq pixels x 8 channels per owner
  const int cgs = Cout / 8;
  const bool owner = !clustered && tid < (L.poutp / p.rq) * cgs;
  const int q0 = (tid / cgs) * p.rq, co0 = (tid % cgs) * 8;
  float acc[F_MAX_RQ * 8];
#pragma unroll
  for (int r = 0; r < F_MAX_RQ * 8; ++r) acc[r] = 0.f;
  auto project = [&](const float* w_p, const float* d) {
    if (!owner) return;
    for (int j = 0; j < F_CH; ++j) {
      float w[8];
      load4(w_p + j * Cout + co0, w);
      load4(w_p + j * Cout + co0 + 4, w + 4);
#pragma unroll
      for (int r = 0; r < F_MAX_RQ; ++r) {
        if (r < p.rq) {
          const float dv = d[(q0 + r) * F_DS + j];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r * 8 + c] = fmaf(dv, w[c], acc[r * 8 + c]);
        }
      }
    }
  };

  // A software pipeline with one barrier per step: step i runs the expand
  // of chunk i, the depthwise of chunk i - 1 and (no cluster) the project
  // of chunk i - 2; each reads what the step before wrote, so the buffers
  // alternate (with a cluster each depthwise chunk keeps its own). After
  // the barrier the weights of the chunks step i + 2 needs go in flight
  // (cp.async) into the ring stages step i released.
  for (int i = 0; i < nloc + (clustered ? 1 : 2); ++i) {
    if (i < nloc) expand(i, we_s + (i & 1) * L.e_part, e_s + (i & 1) * ebuf);
    if (i >= 1 && i <= nloc)
      depthwise(wd_s + ((i - 1) & 1) * L.d_part, e_s + ((i - 1) & 1) * ebuf,
                d_s + (clustered ? i - 1 : (i - 1) & 1) * dbuf);
    if (i >= 2) project(wp_s + (i & 1) * L.p_part, d_s + (i & 1) * dbuf);
    cp_async_wait_all();
    __syncthreads();
    if (p.expand && i + 2 < nloc) stage(we_s + (i & 1) * L.e_part, i + 2, 0, L.e_part);
    if (i + 1 < nloc) stage(wd_s + ((i + 1) & 1) * L.d_part, i + 1, L.e_part, L.d_part);
    if (!clustered && i < nloc) stage(wp_s + (i & 1) * L.p_part, i, L.e_part + L.d_part, L.p_part);
    cp_async_commit();
  }

  // epilogue: + bias [+ residual], store the pixels inside the map
  float* ob = p.out + size_t(b) * Ho * Wo * Cout;
  auto store = [&](int q, int co, float4 v) {
    const int qy = q / p.tw, qx = q - qy * p.tw;
    const int oy = oy0 + qy, ox = ox0 + qx;
    if (oy >= Ho || ox >= Wo) return;
    add4(v, *reinterpret_cast<const float4*>(p.bp + co));
    if (S == 1 && p.residual)
      add4(v, *reinterpret_cast<const float4*>(x_s + ((qy + 1) * win + qx + 1) * XS + co));
    *reinterpret_cast<float4*>(ob + (size_t(oy) * Wo + ox) * Cout + co) = v;
  };
  if (!clustered) {
    if (!owner) return;
#pragma unroll
    for (int r = 0; r < F_MAX_RQ; ++r) {
      if (r >= p.rq || q0 + r >= L.pout) continue;
#pragma unroll
      for (int c = 0; c < 8; c += 4)
        store(q0 + r, co0 + c, make_float4(acc[r * 8 + c], acc[r * 8 + c + 1],
                                           acc[r * 8 + c + 2], acc[r * 8 + c + 3]));
    }
    return;
  }

  // Cluster: the project of channel groups [g0, g1) over all n chunks, in
  // steps of F_BG chunks: each step's depthwise chunks are read from the
  // CTA that made them (distributed shared memory) and its project-weight
  // slices copied from device memory, one step ahead, into two stages. A
  // unit is one pixel x 4 channels; each adds its chunks and channels in
  // order, as the CTA without a cluster does.
  cluster_sync();  // every CTA's depthwise chunks are complete
  const int g0 = rank * cgs / R, g1 = (rank + 1) * cgs / R;
  const int nq4 = (g1 - g0) * 2, units = L.pout * nq4, sl = L.slice;
  float* bd_s = reinterpret_cast<float*>(smem + L.bd);
  float* bw_s = reinterpret_cast<float*>(smem + L.bw);
  const uint32_t dl_addr = smem_u32(smem + L.dl);
  const int bstage_d = F_BG * L.pout * F_CH, bstage_w = F_BG * F_CH * sl;
  auto stage_b = [&](int s, int slot) {
    for (int cc = 0; cc < F_BG; ++cc) {
      const int c = s * F_BG + cc;
      if (c >= p.nchunks) break;
      const int k = ((c + 1) * R - 1) / p.nchunks;  // the CTA whose chunks hold c
      const int li = c - k * p.nchunks / R;
      float* dst = bd_s + slot * bstage_d + cc * L.pout * F_CH;
      for (int i = tid; i < L.pout * F_CH / 4; i += F_NT)
        reinterpret_cast<float4*>(dst)[i] = ld_cluster_f4(dl_addr + (li * dbuf + i * 4) * 4, k);
      const float* src = p.w + size_t(c) * chunk + L.e_part + L.d_part + g0 * 8;
      float* wdst = bw_s + slot * bstage_w + cc * F_CH * sl;
      for (int i = tid; i < F_CH * nq4; i += F_NT) {
        const int j = i / nq4, q4 = i - j * nq4;
        cp_async16(wdst + j * sl + q4 * 4, src + j * Cout + q4 * 4);
      }
    }
    cp_async_commit();
  };
  float4 acc2[F_MAX_UNITS];
#pragma unroll
  for (int m = 0; m < F_MAX_UNITS; ++m) acc2[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int nsteps = (p.nchunks + F_BG - 1) / F_BG;
  stage_b(0, 0);
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // step s is in its stage; the other stage is free
    if (s + 1 < nsteps) stage_b(s + 1, (s + 1) & 1);
    const float* bd = bd_s + (s & 1) * bstage_d;
    const float* bw = bw_s + (s & 1) * bstage_w;
    const int ncc = min(F_BG, p.nchunks - s * F_BG);
#pragma unroll
    for (int m = 0; m < F_MAX_UNITS; ++m) {
      const int u = tid + m * F_NT;
      if (u >= units) break;
      const int q = u / nq4, q4 = u - q * nq4;
      for (int cc = 0; cc < ncc; ++cc) {
        const float* dr = bd + (cc * L.pout + q) * F_CH;
        const float* wr = bw + cc * F_CH * sl + q4 * 4;
#pragma unroll 8
        for (int j = 0; j < F_CH; ++j) {
          const float dv = dr[j];
          const float4 w = *reinterpret_cast<const float4*>(wr + j * sl);
          acc2[m].x = fmaf(dv, w.x, acc2[m].x);
          acc2[m].y = fmaf(dv, w.y, acc2[m].y);
          acc2[m].z = fmaf(dv, w.z, acc2[m].z);
          acc2[m].w = fmaf(dv, w.w, acc2[m].w);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < F_MAX_UNITS; ++m) {
    const int u = tid + m * F_NT;
    if (u >= units) break;
    const int q = u / nq4, q4 = u - q * nq4;
    store(q, g0 * 8 + q4 * 4, acc2[m]);
  }
  cluster_sync();  // no CTA leaves while another reads its depthwise chunks
}

template <int S>
cudaError_t launch_f32(const FParams& p, int B, int tiles, size_t smem, cudaStream_t stream) {
  static bool opted_in[MAX_DEVICES] = {};
  const cudaError_t smem_e = allow_smem(mbconv_f32<S>, opted_in);
  if (smem_e != cudaSuccess) return smem_e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * p.cluster, B);
  cfg.blockDim = dim3(F_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;  // a cluster of one is a plain launch
  cudaError_t e = cudaLaunchKernelEx(&cfg, mbconv_f32<S>, p);
  if (e != cudaSuccess) return e;
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
// most: four while the project sums are small (Cout <= 48), three up to
// NB = 6 (Cout <= 144), else two; with the producer warpgroup that is
// 640, 512 or 384 threads at 96, 128 or 168 registers. The producer keeps
// 32 (24 spilled a register) and the consumers take 112, 160 or 232 each
// from what it gives back (setmaxnreg moves registers within the CTA).
__host__ __device__ constexpr int max_nc(int nb) { return nb <= 2 ? 4 : nb <= 6 ? 3 : 2; }
// The wide instances (NB >= 6, Cout 121-264) hold exactly the launch's
// accumulator blocks, and may split a tile's chunks among `ks` groups of
// consumer warpgroups (see the note at mbconv_wgmma).
__host__ __device__ constexpr bool is_wide(int nb) { return nb >= 6; }
constexpr int BAR_BYTES = 128;  // mbarriers at the start of shared memory
constexpr int MAX_STAGES = 3;

// Geometry of one launch; the host fills it (h_layout) from the tile plan.
struct HParams {
  const unsigned char* w;  // packed weights, nchunks x chunk_bytes
  const float* bp;
  bf16* out;
  int H, W, Cin, Ce, Cout, nchunks, expand, residual;
  int th, tw, nc, ks, xst, wst, tiles_w, items_per_image, items;
  int kpad, coutp, win, hin, pin, pinp;
  // bytes: one input stage, one weight chunk and its parts, shared-memory offsets
  uint32_t x_bytes, chunk_bytes, w_stride, wp_off, wd_off, be_off, bd_off;
  uint32_t x_off, w_off, e_off, e_bytes, smem;
};

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

// The project of one chunk for the first R accumulator blocks, issued as
// one group: acc[nb] += A . wp chunk[:, 24nb : 24nb + 24], k16 step ks of
// every block, then the next step. Straight-line from fence to commit: a
// wgmma under a runtime condition, or a fence or commit across a branch,
// makes ptxas inject arrives (C7519), so the launch's block count picks
// a chain.
template <int R, int NB>
__device__ __forceinline__ void project_chain(float (&acc)[NB][12], const uint32_t (&a)[KS][4],
                                              uint32_t wp, uint32_t lbo_wp) {
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int nb = 0; nb < R; ++nb)
      wgmma_m64n24_rs(acc[nb], a[ks], gmma_desc(wp + nb * 3 * 128 + 2 * ks * lbo_wp, lbo_wp, 128));
  wg_commit();
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
  // the warpgroup index through a shuffle: ptxas then knows it is the same
  // in every thread of a warp, and loops bounded by it are not divergent
  // paths (where an arrive it injects before a wgmma serialises them, C7520)
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0), lane = tid % 32;

  if (tid == 0) {
    // empties count one arrival per consumer warp (of the chunk's group)
    for (int i = 0; i < p.xst; ++i) {
      mbar_init(x_full(i), 1);
      mbar_init(x_empty(i), 4 * p.nc);
    }
    for (int i = 0; i < p.wst; ++i) {
      mbar_init(w_full(i), 1);
      mbar_init(w_empty(i), 4 * (p.nc / p.ks));
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
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
    else if constexpr (max_nc(NB) == 3)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    constexpr bool WIDE = is_wide(NB);
    // chunk group grp (chunks grp, grp + ks, ...) of nm warpgroups; this
    // one computes the tile's rows [64 mwg, 64 mwg + 64)
    const int nm = WIDE ? p.nc / p.ks : p.nc;
    const int grp = WIDE ? wg / nm : 0, mwg = WIDE ? wg % nm : wg;
    const int wid = (tid / 32) % 4, g = lane >> 2, t4 = lane & 3;
    const int nthreads = 128 * p.nc;
    const int win = p.win, pout = p.th * p.tw, Ho = p.H / S, Wo = p.W / S;
    const int nbr = WIDE ? NB : p.coutp / NBW, n_mb = p.pinp / 64, ksteps = p.kpad / 16;
    // this thread's two rows of the project GEMM, g and g + 8 of its warp's
    // 16, are two neighbouring output pixels of one tile row (tw is even),
    // so their 3x3 windows share taps; hb: the window's top-left halo pixel
    const int q0 = 64 * mwg + 16 * wid + 2 * g;
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
      // (a fence and a commit each step: at a runtime loop's head and exit
      // ptxas would inject the arrives itself, note C7519)
      auto expand_issue = [&](int mb, uint32_t wa) {
        for (int k = 0; k < ksteps; ++k) {
          wg_fence();
          wgmma_m64n48_ss(d, gmma_desc(xa + 2 * k * lbo_x + mb * 1024, lbo_x, 128),
                          gmma_desc(wa + 2 * k * lbo_we, lbo_we, 128), k > 0);
          wg_commit();
        }
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
        for (int mb = mb0; mb < n_mb; mb += nm) {
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
      // project partial sums, issued, over the launch's nbr blocks (NB 2
      // and 5 take 1-2 and 3-5; a wide instance exactly NB). Every k16 step,
      // a ragged chunk's padding too: its A fragments and weights are zero
      auto project_issue = [&](const uint32_t (&a)[KS][4], uint32_t wa) {
        const uint32_t wp = wa + p.wp_off;
        if constexpr (NB == 2) {
          if (nbr == 1) project_chain<1>(acc, a, wp, lbo_wp);
          else project_chain<2>(acc, a, wp, lbo_wp);
        } else if constexpr (NB == 5) {
          if (nbr == 3) project_chain<3>(acc, a, wp, lbo_wp);
          else if (nbr == 4) project_chain<4>(acc, a, wp, lbo_wp);
          else project_chain<5>(acc, a, wp, lbo_wp);
        } else {
          project_chain<NB>(acc, a, wp, lbo_wp);
        }
      };
      auto project_done = [&](uint32_t (&a)[KS][4]) {
        wg_wait0();
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) fence_regs(a[ks]);
      };

      if (WIDE && p.ks > 1) {
        // The chunks split among ks groups of nm warpgroups: group grp
        // sums chunks grp, grp + ks, ... of the tile into its own project
        // accumulators, expanding each into its own buffer (no run-ahead:
        // two group barriers a chunk). Stage of chunk c: this CTA's item
        // count k times nchunks plus c, modulo wst, as the producer fills
        // them. The stages of the item's last wst chunks are released only
        // after the reduction below, which uses them.
        const int k_item = (item - int(blockIdx.x)) / int(gridDim.x);
        ebuf = grp;
        for (int c = grp; c < p.nchunks; c += p.ks) {
          const int cval = min(CH, p.Ce - c * CH);
          const int s = k_item * p.nchunks + c, st = s % p.wst;
          mbar_wait(w_full(st), (s / p.wst) & 1);
          if (p.expand) {
            expand_blocks(mwg, stage_addr(st), stage_ptr(st), e_ptr(ebuf));
            named_bar_sync(2 + grp, 128 * nm);  // the chunk is read across the group
          }
          uint32_t a[KS][4];
          depthwise(a, c, cval, stage_ptr(st));
          project_issue(a, stage_addr(st));
          project_done(a);
          if (lane == 0 && c < p.nchunks - p.wst) mbar_arrive(w_empty(st));
          if (p.expand) named_bar_sync(2 + grp, 128 * nm);  // read before the next expand
        }
        // Reduction in a fixed order, no atomics: groups 1..ks-1 write
        // their sums to the weight ring (every stage holds one of the
        // item's last wst chunks, read by now and not yet released, so the
        // producer writes none), group 0 adds them in group order. A
        // thread writes the accumulators of its own fragment position, the
        // one that holds the same outputs in group 0: [group][M block]
        // [register][thread], conflict-free.
        named_bar_sync(1, nthreads);  // every group is done with every stage
        float* red = reinterpret_cast<float*>(sm + p.w_off) + (tid % 128);
        const int part = nbr * 12 * 128;
        if (grp > 0) {
          float* r = red + ((grp - 1) * nm + mwg) * part;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int i = 0; i < 12; ++i) r[(nb * 12 + i) * 128] = acc[nb][i];
        }
        named_bar_sync(1, nthreads);
        if (grp == 0)
          for (int gg = 1; gg < p.ks; ++gg) {
            const float* r = red + ((gg - 1) * nm + mwg) * part;
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
#pragma unroll
              for (int i = 0; i < 12; ++i) acc[nb][i] += r[(nb * 12 + i) * 128];
          }
        // the ring's next writes are the producer's bulk copies
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        named_bar_sync(1, nthreads);
        if (lane == 0)
          for (int c = p.nchunks - p.wst; c < p.nchunks; ++c)
            if (c % p.ks == grp) mbar_arrive(w_empty((k_item * p.nchunks + c) % p.wst));
      } else {
        // chunk 0's expand; later chunks' expands run one chunk ahead. It
        // takes the buffer the previous item's last chunk did not use: every
        // warpgroup has passed a barrier since it last read that one
        mbar_wait(w_full(ws), wph);
        if (p.expand) {
          ebuf ^= 1;
          expand_blocks(wg, stage_addr(ws), stage_ptr(ws), e_ptr(ebuf));
          named_bar_sync(1, nthreads);  // the chunk is read across warpgroups
        }

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
            project_issue(a, stage_addr(ws));
            wg_wait1();  // the expand; the project's group is the newer one
            expand_store(wg, stage_ptr(ws_n), e_ptr(ebuf ^ 1));
            expand_blocks(wg + p.nc, stage_addr(ws_n), stage_ptr(ws_n), e_ptr(ebuf ^ 1));
            project_done(a);
            if (lane == 0) mbar_arrive(w_empty(ws));  // this warp is done with the stage
            named_bar_sync(1, nthreads);  // the next chunk is read across warpgroups
            ebuf ^= 1;
          } else {
            depthwise(a, c, cval, w_s);
            project_issue(a, stage_addr(ws));
            project_done(a);
            if (lane == 0) mbar_arrive(w_empty(ws));
          }
          if (++ws == p.wst) { ws = 0; wph ^= 1; }
        }
      }

      // epilogue: + bias [+ residual], round, store the pixels inside the map
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // accumulator row g + 8r: pixel q0 + r
        const int q = q0 + r;
        if (q >= pout || grp > 0) continue;  // (with chunk groups, group 0 stores)
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
  // expanded chunks: two (one ahead), or one for each chunk group
  p.smem = p.e_off + (p.ks > 1 ? p.ks : 2) * p.e_bytes + 128;  // + room to align the base
}

// Bytes of the chunk groups' partial sums (groups 1..ks-1), which the
// reduction writes over the weight ring.
uint32_t red_bytes(const HParams& p) {
  return uint32_t(p.ks - 1) * (p.nc / p.ks) * 128 * (p.coutp / NBW) * 12 * 4;
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
  static bool opted_in[MAX_DEVICES] = {};
  const cudaError_t smem_e = allow_smem(mbconv_wgmma<S, NB>, opted_in);
  if (smem_e != cudaSuccess) return smem_e;
  if (p.nc > max_nc(NB)) return cudaErrorInvalidValue;
  mbconv_wgmma<S, NB><<<grid, 128 * (p.nc + 1), p.smem, stream>>>(map, p);
  return cudaGetLastError();
}

// The instance for a launch: NB 2 or 5 hold up to that many accumulator
// blocks (Cout <= 120); past that, the instance with exactly the launch's.
template <int S>
cudaError_t launch_wgmma_nb(const CUtensorMap& map, const HParams& p, int grid,
                            cudaStream_t stream) {
  const int nbr = p.coutp / NBW;
  if (p.ks > 1 && !is_wide(nbr)) return cudaErrorInvalidValue;
  switch (nbr) {
    case 1: case 2: return launch_wgmma<S, 2>(map, p, grid, stream);
    case 3: case 4: case 5: return launch_wgmma<S, 5>(map, p, grid, stream);
    case 6: return launch_wgmma<S, 6>(map, p, grid, stream);
    case 7: return launch_wgmma<S, 7>(map, p, grid, stream);
    case 8: return launch_wgmma<S, 8>(map, p, grid, stream);
    case 9: return launch_wgmma<S, 9>(map, p, grid, stream);
    case 10: return launch_wgmma<S, 10>(map, p, grid, stream);
    case 11: return launch_wgmma<S, 11>(map, p, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// float32: x [B, H, W, Cin]; w the packed weights of ops/mbconv.py::
// pack_mbconv_f32 (nchunks chunks of 32 expanded channels); bp [Cout];
// out [B, H/stride, W/stride, Cout]. The plan (th x tw output pixels, rq
// project and px expand pixels per thread, `cluster` CTAs per (tile,
// image), `smem` bytes) comes from ops/mbconv.py::plan_tile_f32; a plan this file would
// lay out differently is refused. Needs Cin % 4 == 0, Cout % 8 == 0 and
// x, w, bp, out 16-byte aligned. Returns the CUDA error (0 on success).
int yrt_mbconv_f32(const void* x, const void* w, const void* bp, void* out, int B, int H, int W,
                   int Cin, int Ce, int Cout, int nchunks, int stride, int expand, int residual,
                   int th, int tw, int rq, int px, int cluster, int smem, void* stream) {
  auto misaligned = [](const void* v) { return reinterpret_cast<uintptr_t>(v) % 16 != 0; };
  if (Cin % 4 || Cout % 8 || (stride != 1 && stride != 2) ||
      (stride == 2 && (H % 2 || W % 2)) || (residual && (stride != 1 || Cin != Cout)) ||
      (!expand && Ce != Cin) || nchunks != (Ce + F_CH - 1) / F_CH || misaligned(x) ||
      misaligned(w) || misaligned(bp) || misaligned(out) || th < 1 || tw < 1 ||
      (rq != 1 && rq != 2 && rq != 4) || (px != 1 && px != 2 && px != 4) || cluster < 1 ||
      cluster > F_MAX_CLUSTER || cluster > nchunks ||
      (cluster == 1 && (round_up(th * tw, rq) / rq) * (Cout / 8) > F_NT) ||
      (cluster > 1 && rq != 1) ||
      (cluster > 1 && th * tw * ((Cout / 8 + cluster - 1) / cluster) * 2 > F_MAX_UNITS * F_NT) ||
      B < 1 || B > 65535)
    return int(cudaErrorInvalidValue);
  const FLayout L = f_layout(stride, th, tw, rq, Cin, Cout, expand, cluster, nchunks);
  if (L.total != size_t(smem) || L.total > size_t(SMEM_LIMIT)) return int(cudaErrorInvalidValue);
  FParams p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.bp = static_cast<const float*>(bp);
  p.out = static_cast<float*>(out);
  p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.nchunks = nchunks;
  p.expand = expand; p.residual = residual;
  p.th = th; p.tw = tw; p.rq = rq; p.px = px; p.cluster = cluster;
  p.tiles_w = (W / stride + tw - 1) / tw;
  const int tiles = p.tiles_w * ((H / stride + th - 1) / th);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(stride == 1 ? launch_f32<1>(p, B, tiles, smem, s)
                         : launch_f32<2>(p, B, tiles, smem, s));
}

// bfloat16: x [B, H, W, Cin]; w the packed weights of ops/mbconv.py::
// pack_mbconv (nchunks chunks); bp [Cout] float32; out [B, H/stride,
// W/stride, Cout]. The tile plan (th x tw output pixels, nc consumer
// warpgroups in ks chunk groups, xst input and wst weight stages, a
// persistent grid of `grid` CTAs, `smem` bytes) comes from
// ops/mbconv.py::plan_tile; a plan
// this file would lay out differently is refused. Needs Cin % 8 == 0,
// Cout % 8 == 0 and x 16-byte aligned. Returns the CUDA error (0 on success).
int yrt_mbconv_bf16(const void* x, const void* w, const void* bp, void* out, int B, int H, int W,
                    int Cin, int Ce, int Cout, int nchunks, int stride, int expand, int residual,
                    int th, int tw, int nc, int ks, int xst, int wst, int grid, int smem,
                    void* stream) {
  if (Cin % 8 || Cout % 8 || (stride != 1 && stride != 2) ||
      (stride == 2 && (H % 2 || W % 2)) || (residual && (stride != 1 || Cin != Cout)) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 || th < 1 ||
      tw < 2 || tw % 2 || nc < 1 || nc > MAX_NC || ks < 1 || nc % ks ||
      th * tw > 64 * (nc / ks) || xst < 1 || xst > MAX_STAGES || wst < 1 || wst > MAX_STAGES ||
      grid < 1 || Ce % 8 || nchunks != (Ce + CH - 1) / CH || (!expand && Ce != Cin) ||
      (ks > 1 && (nchunks < wst || nchunks < ks)))
    return int(cudaErrorInvalidValue);
  HParams p;
  p.w = static_cast<const unsigned char*>(w);
  p.bp = static_cast<const float*>(bp);
  p.out = static_cast<bf16*>(out);
  p.H = H; p.W = W; p.Cin = Cin; p.Ce = Ce; p.Cout = Cout; p.nchunks = nchunks;
  p.expand = expand; p.residual = residual;
  p.th = th; p.tw = tw; p.nc = nc; p.ks = ks; p.xst = xst; p.wst = wst;
  const int Ho = H / stride, Wo = W / stride;
  p.tiles_w = (Wo + tw - 1) / tw;
  p.items_per_image = p.tiles_w * ((Ho + th - 1) / th);
  p.items = B * p.items_per_image;
  h_layout(p, stride);
  if (int(p.smem) != smem || p.smem > SMEM_LIMIT || p.win > 256 || p.hin > 256 ||
      red_bytes(p) > p.wst * p.w_stride)
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
