// Z-buffer forward warp for Hopper (sm_90a).
//
// Replaces the JAX package's `ops/forward_warp.py:forward_warp`, which is
// not a Pallas kernel: it sorts (target, depth bits, source index) with
// one 3-key `lax.sort` and scatters each run's head. It stands where the
// reference's L0 CUDA kernel `alt_cuda/fw_cuda` stood, which scanned the
// sources serially in raster order.
//
// What it computes, per batch entry b and source pixel p = (y, x):
//   target  t = trunc(clamp(y + fy, 0, H-1)) * W + trunc(clamp(x + fx, 0, W-1))
//   winner of t: the smallest depth; among equal depths the smallest p;
//   out[c, t] = obj[c, winner] if the winner's depth < 1000, else 0;
//   valid[t] = 1 if any p targets t; collision[t] = valid and not < 1000.
//
// Design: two passes, one thread a pixel each.
//   1. Each source pixel computes its target and atomicMin's the key
//      (sortable(depth) << 32) | p into a u64 z-buffer set to ~0. The
//      order-preserving map sends negative floats to their inverted bits
//      and the others to their bits with the sign bit set, so -0.0 < +0.0
//      as in the JAX package's `_float_to_sortable_int`. A minimum does
//      not depend on the order of the atomics: the result is
//      deterministic, and bit-equal to the plain version.
//   2. Each target pixel decodes its winner and gathers its C channels
//      and depth; it writes out, valid and collision.
// Bound: bytes (flow, depth and the z-buffer in pass 1; the z-buffer and
// C + 1 gathered channels in pass 2; C + 2 channels written). Targets on
// which many sources clamp (the border under a large rotation or flow)
// serialise their atomics on one address; a warp pre-reduction
// (__match_any_sync) is a later step.
//
// The wrapper (ops/forward_warp.py) checks shapes and dtypes, allocates
// out, valid, collision and the z-buffer, and passes PyTorch's stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned int sortable_u32(float d) {
    const unsigned int bits = __float_as_uint(d);
    return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__global__ void zbuffer_kernel(const float* __restrict__ flow,
                               const float* __restrict__ depth,
                               unsigned long long* __restrict__ zbuf,
                               long long total, int h, int w) {
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= total) return;
    const long long n = (long long)h * w;
    const long long b = i / n;
    const int p = (int)(i - b * n);
    const int y = p / w;
    const int x = p - y * w;
    const float* fb = flow + b * 2 * n;
    // clamp then truncate (the values are >= 0 after the clamp)
    const float px = fminf(fmaxf((float)x + fb[p], 0.0f), (float)(w - 1));
    const float py = fminf(fmaxf((float)y + fb[n + p], 0.0f), (float)(h - 1));
    const long long t = (long long)(int)py * w + (int)px;
    const unsigned long long key =
        ((unsigned long long)sortable_u32(depth[i]) << 32) | (unsigned)p;
    atomicMin(zbuf + b * n + t, key);
}

__global__ void gather_kernel(const float* __restrict__ obj,
                              const float* __restrict__ depth,
                              const unsigned long long* __restrict__ zbuf,
                              float* __restrict__ out,
                              float* __restrict__ valid,
                              float* __restrict__ collision,
                              long long total, int c, long long n) {
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= total) return;
    const long long b = i / n;
    const long long t = i - b * n;
    const unsigned long long key = zbuf[i];
    const bool hit = key != ~0ull;
    const long long src = hit ? (long long)(unsigned)(key & 0xffffffffull) : 0;
    const float wd = depth[b * n + src];
    const bool ok = hit && wd < 1000.0f;
    const float* ob = obj + b * c * n;
    float* oo = out + b * c * n;
    for (int k = 0; k < c; ++k)
        oo[k * n + t] = ok ? ob[k * n + src] : 0.0f;
    valid[i] = hit ? 1.0f : 0.0f;
    collision[i] = (hit && !(wd < 1000.0f)) ? 1.0f : 0.0f;
}

}  // namespace

// obj [B, C, H, W], flow [B, 2, H, W], depth [B, 1, H, W] f32, contiguous;
// zbuf B*H*W u64 scratch; out [B, C, H, W], valid and collision [B, 1, H, W].
// Returns the CUDA error of the launches (0 on success).
extern "C" int ofd_forward_warp(const void* obj, const void* flow,
                                const void* depth, void* zbuf, void* out,
                                void* valid, void* collision, int b, int c,
                                int h, int w, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long n = (long long)h * w;
    const long long total = (long long)b * n;
    if (total == 0) return 0;
    cudaError_t err = cudaMemsetAsync(zbuf, 0xff, total * 8, s);
    if (err != cudaSuccess) return err;
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    zbuffer_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const float*>(flow), static_cast<const float*>(depth),
        static_cast<unsigned long long*>(zbuf), total, h, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gather_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const float*>(obj), static_cast<const float*>(depth),
        static_cast<const unsigned long long*>(zbuf),
        static_cast<float*>(out), static_cast<float*>(valid),
        static_cast<float*>(collision), total, c, n);
    return cudaGetLastError();
}
