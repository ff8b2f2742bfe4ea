// The frozen-path replay of a triangle scene for inverse rendering: the
// image loss and its gradient with respect to the (K, 3) material albedo
// table, in one pass over the recorded paths.
//
//   replay_loss_kernel  replaces no TPU kernel: the JAX package replays the
//                       recorded paths in plain jnp (rt/grad/replay.py) and
//                       differentiates them with jax.grad.  The port did the
//                       same through torch.autograd (rt_torch/grad/replay.py:
//                       replay_color + the image loss), about a thousand
//                       launches a step and an embedding backward's segment
//                       sort of every pixel's row ids.  Where the albedo is
//                       the only leaf and the geometry is frozen, the
//                       transport a pixel replays depends on the albedo only
//                       through the product of its hit bounces' albedos, so
//                       the gradient is written out by hand here.
//   replay_sum_kernel   the blocks' partial sums added in a fixed order.
//
// One thread replays one pixel exactly as replay_color does: the primary ray
// of K0's raygen; then for each bounce whose recorded triangle id is >= 0,
// that triangle's table row (read by id, through L1/L2: Suzanne's 1095 rows
// are 57 KB), the Moeller-Trumbore t of the known triangle with the replay's
// EPSILON and t > 0 guards, the frozen face normal, K0's scatter for the
// row's material and atten *= albedo * 0.7; then the sky of the final or of
// the primary direction.  With d = color - target, a pixel's weight w and
// the divisor N (the band's H*W*3 for a plain mean, or the caller's),
//   L          = sum w d^2 / N
//   dL/da[k,c] = sum over hit bounces b of material k of
//                2 w d_c / N * sky_c * 0.7 * prod_{b' != b} (a[k_b', c] * 0.7).
//
// The gradient is carried forward with the transport: a thread's column
// D[k] for each material k of its block's chunk holds d atten / d a[k], and
// a hit bounce of material m, factor f = a[m] * 0.7, makes
//   D[k] <- D[k] * f  for every k,  then  D[m] += atten * 0.7
// with atten the product before the bounce.  So D[k] sums, over k's
// bounces, the product of every other bounce's factor: the hits are read
// once, no bounce is visited twice, and a zero albedo is safe (nothing is
// divided).  At the end D[k] *= w d sky; the second launch gives the 2 / N.
//
// Reduction: the columns live in shared memory, one a thread, for the loss
// and the 3 x REPLAY_CHUNK entries of the block's chunk of materials (grid
// y: one chunk each, so the table may have any number of materials).  The
// block sums them in a fixed tree and writes one partial sum an entry; the
// second launch adds each entry's partials in float64 in a fixed order.  No
// atomics: two launches give the same bits.
//
// Bound (Suzanne 1920x1080, 5 bounces): bytes, the hits (5 x 4 B) and the
// target (12 B) a pixel, 66 MB in all, 0.020 ms at 3.35 TB/s; operations,
// about 700 f32 a pixel (raygen 102, five replayed bounces, the sky and the
// loss), 1.5 GFLOP, 0.022 ms at 67 TFLOP/s.  Design: no scan and no sort,
// so the kernel is one streaming pass over the hits; the triangle and
// material tables stay in cache, read by id.
//
// Built with -fmad=false: the replay rounds every multiply and add, so the
// kernel must not contract them, and the colour is bit-equal to it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "rt_device.cuh"

namespace rt {

constexpr int REPLAY_BLOCK = 128;
constexpr int REPLAY_CHUNK = 16;  // materials a block's columns hold
constexpr int REPLAY_SUM_BLOCK = 256;
constexpr int REPLAY_COLS = 13;  // a, b - a, c - a, normal, material id
constexpr float REPLAY_EPSILON = 1e-4f;  // EPSILON_TRIS

struct ReplayFrame {
    CameraRow cam;
    uint32_t time;
    int row0, rows, height, width, bounces, n_mats, n_tris;
    int normalize_defocus_dir, sky_from_final_dir;
    ScatterFlags flags;
};

// the recorded triangle id of a bounce, -1 on a miss, clamped to the table
// as the replay's lookup clamps it
__device__ __forceinline__ int replay_id(const int* __restrict__ hits,
                                         size_t at, int n_tris) {
    const int id = __ldg(hits + at);
    return id < n_tris ? id : n_tris - 1;
}

// grid (ceil(rows*width / REPLAY_BLOCK), ceil(K / REPLAY_CHUNK)), block
// REPLAY_BLOCK; dynamic shared memory (1 + 3 x min(K, REPLAY_CHUNK)) x
// REPLAY_BLOCK floats.  partial: (1 + 3K, gridDim.x), entry 0 the loss
// (chunk 0 writes it), entry 1 + 3k + c material k's channel c.  weight:
// (rows, width) or null (1 a pixel).  color: (rows, width, 3) or null (not
// written).
__global__ void __launch_bounds__(REPLAY_BLOCK)
replay_loss_kernel(ReplayFrame f, const float* __restrict__ tab,
                   const float* __restrict__ albedo,
                   const float* __restrict__ param,
                   const int* __restrict__ kind, const int* __restrict__ hits,
                   const float* __restrict__ target,
                   const float* __restrict__ weight,
                   float* __restrict__ partial, float* __restrict__ color) {
    extern __shared__ float acc[];
    const int k0 = blockIdx.y * REPLAY_CHUNK;
    const int nk = min(REPLAY_CHUNK, f.n_mats - k0);
    const int entries = 1 + 3 * nk;
    const int tid = threadIdx.x;
    for (int e = 0; e < entries; ++e) acc[e * REPLAY_BLOCK + tid] = 0.0f;
    // D[j][c], material k0 + j's channel c, at (3j + c) * REPLAY_BLOCK
    float* grad = acc + REPLAY_BLOCK + tid;

    const size_t plane = (size_t)f.rows * f.width;
    const size_t p = (size_t)blockIdx.x * REPLAY_BLOCK + tid;
    if (p < plane) {
        const int row = (int)(p / f.width), col = (int)(p % f.width);
        uint32_t state;
        Vec3 o, d;
        generate_ray(f.cam, (uint32_t)col, (uint32_t)(row + f.row0), f.height,
                     f.width, f.time, f.normalize_defocus_dir != 0, state, o,
                     d);
        const float primary_dy = d.y;
        Vec3 atten = {1.0f, 1.0f, 1.0f};
        bool live = false;  // a bounce of the chunk's materials was hit
        for (int b = 0; b < f.bounces; ++b) {
            const int id = replay_id(hits, b * plane + p, f.n_tris);
            if (id < 0) continue;
            const float* r = tab + (size_t)id * REPLAY_COLS;
            const Vec3 a = {__ldg(r + 0), __ldg(r + 1), __ldg(r + 2)};
            const Vec3 e1 = {__ldg(r + 3), __ldg(r + 4), __ldg(r + 5)};
            const Vec3 e2 = {__ldg(r + 6), __ldg(r + 7), __ldg(r + 8)};
            const Vec3 n = {__ldg(r + 9), __ldg(r + 10), __ldg(r + 11)};
            const int m = (int)__ldg(r + 12);
            // the replay's t of the known triangle
            const Vec3 h = cross3(d, e2);
            const float det = dot3(e1, h);
            const bool ok = fabsf(det) >= REPLAY_EPSILON;
            const float inv_det = 1.0f / (ok ? det : 1.0f);
            const Vec3 q = cross3(sub3(o, a), e1);
            float t = inv_det * dot3(e2, q);
            t = (ok && t > 0.0f) ? t : 1.0f;
            const Vec3 point = add3(o, scale3(d, t));
            const bool front_face = dot3(n, d) > 0.0f;
            scatter(state, d, n, front_face, __ldg(param + m), __ldg(kind + m),
                    f.flags);
            o = point;
            const Vec3 alb = {__ldg(albedo + 3 * m + 0),
                              __ldg(albedo + 3 * m + 1),
                              __ldg(albedo + 3 * m + 2)};
            if (live) {  // every D through this bounce's factor
                const Vec3 fac = scale3(alb, 0.7f);
                for (int e = 0; e < 3 * nk; e += 3) {
                    grad[e * REPLAY_BLOCK] *= fac.x;
                    grad[(e + 1) * REPLAY_BLOCK] *= fac.y;
                    grad[(e + 2) * REPLAY_BLOCK] *= fac.z;
                }
            }
            const int j = m - k0;
            if (j >= 0 && j < nk) {  // and the bounce's own term
                float* dj = grad + 3 * j * REPLAY_BLOCK;
                dj[0] += atten.x * 0.7f;
                dj[REPLAY_BLOCK] += atten.y * 0.7f;
                dj[2 * REPLAY_BLOCK] += atten.z * 0.7f;
                live = true;
            }
            atten = {atten.x * alb.x * 0.7f, atten.y * alb.y * 0.7f,
                     atten.z * alb.z * 0.7f};
        }
        const float dy = f.sky_from_final_dir ? d.y : primary_dy;
        const Vec3 c = sky_times_atten(dy, atten);
        const Vec3 sky = sky_times_atten(dy, {1.0f, 1.0f, 1.0f});
        if (color && blockIdx.y == 0) {
            color[3 * p + 0] = c.x;
            color[3 * p + 1] = c.y;
            color[3 * p + 2] = c.z;
        }
        const float w = weight ? __ldg(weight + p) : 1.0f;
        const Vec3 diff = {c.x - __ldg(target + 3 * p + 0),
                           c.y - __ldg(target + 3 * p + 1),
                           c.z - __ldg(target + 3 * p + 2)};
        acc[tid] = diff.x * diff.x * w + diff.y * diff.y * w
                   + diff.z * diff.z * w;
        if (live) {
            // the loss's derivative by the colour, without its 2 / N, times
            // the colour's by atten
            const Vec3 g = {w * diff.x * sky.x, w * diff.y * sky.y,
                            w * diff.z * sky.z};
            for (int e = 0; e < 3 * nk; e += 3) {
                grad[e * REPLAY_BLOCK] *= g.x;
                grad[(e + 1) * REPLAY_BLOCK] *= g.y;
                grad[(e + 2) * REPLAY_BLOCK] *= g.z;
            }
        }
    }
    for (int s = REPLAY_BLOCK / 2; s > 0; s >>= 1) {
        __syncthreads();
        if (tid < s)
            for (int e = 0; e < entries; ++e)
                acc[e * REPLAY_BLOCK + tid] += acc[e * REPLAY_BLOCK + tid + s];
    }
    __syncthreads();
    for (int e = tid; e < entries; e += REPLAY_BLOCK) {
        if (e == 0 && blockIdx.y != 0) continue;  // chunk 0 writes the loss
        const int entry = e == 0 ? 0 : 3 * k0 + e;
        partial[(size_t)entry * gridDim.x + blockIdx.x] =
            acc[e * REPLAY_BLOCK];
    }
}

// grid 1 + 3K, block REPLAY_SUM_BLOCK: entry blockIdx.x of the partials,
// summed in float64 in a fixed order, over the divisor: the loss (entry 0)
// and 2 / N times the gradient's sums.
__global__ void __launch_bounds__(REPLAY_SUM_BLOCK)
replay_sum_kernel(const float* __restrict__ partial, int n_blocks,
                  const float* __restrict__ norm, double count,
                  float* __restrict__ loss, float* __restrict__ grad) {
    __shared__ double s[REPLAY_SUM_BLOCK];
    const int e = blockIdx.x, tid = threadIdx.x;
    double v = 0.0;
    for (int i = tid; i < n_blocks; i += REPLAY_SUM_BLOCK)
        v += (double)partial[(size_t)e * n_blocks + i];
    s[tid] = v;
    for (int k = REPLAY_SUM_BLOCK / 2; k > 0; k >>= 1) {
        __syncthreads();
        if (tid < k) s[tid] += s[tid + k];
    }
    if (tid == 0) {
        const double n = norm ? (double)*norm : count;
        if (e == 0)
            *loss = (float)(s[0] / n);
        else
            grad[e - 1] = (float)(2.0 * s[0] / n);
    }
}

}  // namespace rt

// ---- plain C interface (loaded with ctypes) ---------------------------------
// Pointers are device pointers except ``cam`` (20 host floats).  tab (m, 13),
// albedo (K, 3), param (K,), kind (K,) int32, hits (bounces, rows, width)
// int32 scene triangle ids (-1: no hit), target (rows, width, 3), weight
// (rows, width) or null, norm (1,) or null (then N = rows * width * 3),
// partial (1 + 3K) * ceil(rows * width / 128) floats of scratch, loss (1,),
// grad (K, 3), color (rows, width, 3) or null.  Launches on ``stream`` and
// returns cudaGetLastError() as an int.
extern "C" int rt_replay_loss(
        const float* tab, const float* albedo, const float* param,
        const int* kind, const int* hits, const float* target,
        const float* weight, const float* norm, float* partial, float* loss,
        float* grad, float* color, const float* cam, unsigned int time,
        int row0, int rows, int height, int width, int bounces, int n_mats,
        int n_tris, int normalize_defocus_dir, int normalize_reflect_in,
        int sky_from_final_dir, void* stream) {
    rt::ReplayFrame f;
    for (int c = 0; c < 20; ++c) f.cam.v[c] = cam[c];
    f.time = time;
    f.row0 = row0;
    f.rows = rows;
    f.height = height;
    f.width = width;
    f.bounces = bounces;
    f.n_mats = n_mats;
    f.n_tris = n_tris;
    f.normalize_defocus_dir = normalize_defocus_dir;
    f.sky_from_final_dir = sky_from_final_dir;
    // the replay evaluates all three arms of the scatter
    f.flags = {normalize_reflect_in, 1, 1};
    const long long pixels = (long long)rows * width;
    const int n_blocks =
        (int)((pixels + rt::REPLAY_BLOCK - 1) / rt::REPLAY_BLOCK);
    const int n_chunks = (n_mats + rt::REPLAY_CHUNK - 1) / rt::REPLAY_CHUNK;
    const size_t shared = (size_t)(1 + 3 * std::min(n_mats, rt::REPLAY_CHUNK))
                          * rt::REPLAY_BLOCK * sizeof(float);
    cudaStream_t s = (cudaStream_t)stream;
    rt::replay_loss_kernel<<<dim3(n_blocks, n_chunks), rt::REPLAY_BLOCK,
                             shared, s>>>(
        f, tab, albedo, param, kind, hits, target, weight, partial, color);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rt::replay_sum_kernel<<<1 + 3 * n_mats, rt::REPLAY_SUM_BLOCK, 0, s>>>(
        partial, n_blocks, norm, (double)pixels * 3.0, loss, grad);
    return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
