// Wavefront triangle path-trace kernels for Hopper (sm_90a).
//
//   wave_first_kernel   replaces rt/kernels/tris_kernel.py:_wave_first_kernel
//                       (raygen fused with bounce 0 over pixel tiles)
//   wave_bounce_kernel  replaces rt/kernels/tris_kernel.py:_wave_bounce_kernel
//                       (n_bounces fused bounces over one tile of the sorted
//                       ray stream, payload updated in place)
//   wave_raygen_kernel  replaces rt/kernels/tris_kernel.py:_wave_raygen_kernel
//                       (primary rays only, for more than one sample per
//                       pixel: every sample's bounces start from them)
//
// The first two call one trace_bounce(), as both TPU kernels call
// _trace_bounce, so they agree per ray.  The raygen kernel calls the same
// generate_ray() as wave_first_kernel; it writes 8 words per pixel and is
// bound by bytes.
//
// What the TPU kernel does on (th, tw) planes with selects, this does with
// one thread per ray; one block is one tile.  The tile is the unit of two
// decisions that change which (ray, triangle) pairs are tested, so it is
// kept: a chunk of 32 triangles is scanned only when some live ray of the
// TILE enters its box nearer than its best hit (the TPU's
// lax.cond(jnp.any(live)) becomes __syncthreads_or), and chunks are visited
// in a per-tile front-to-back order read at blockIdx * n_chunks.  Inside a
// live chunk every live ray of the tile scans all 32 triangles in ascending
// index with strict t < best, also a ray whose own box test failed: that is
// what the plain version does, and it keeps the image equal at equal tile
// shape.  Rays that are already dead skip the scan; their result is
// discarded by the hit mask in either version.
//
// Bound: operations.  The scan does ~47 f32 operations per (ray, triangle)
// pair on 52 bytes of triangle that the whole block reads at one address (a
// broadcast served from L1), while the payload is 23 words per ray per
// launch.  No shared-memory staging or tensor-core use yet; see PERF.md.
//
// Built with -fmad=false: the plain version rounds every multiply and add,
// so the kernel must not contract them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rt_device.cuh"

namespace rt {

constexpr float EPSILON_TRIS = 1e-4f;
constexpr int TRI_COLS = 13;  // a(3) e1(3) e2(3) normal(3) mat_id

struct Tables {
    const float* tab;     // (m_pad, 13)
    const float* mats;    // (n_mats, 5): albedo rgb, param, kind
    const float* chunks;  // (n_chunks, 6): box min xyz, max xyz
    int n_chunks;
    int chunk;
    int n_mats;
    ScatterFlags flags;
};

// One bounce for this thread's ray.  EVERY thread of the block must call it
// (block-wide votes inside).  order: this tile's n_chunks visit entries.
// Returns the winning chunk id, -1 on a miss or a dead ray.
__device__ int trace_bounce(const Tables& p, const int* __restrict__ order,
                            Ray& r) {
    const bool alive = r.active > 0;
    const Vec3 o = r.o, d = r.d;
    const float idx = 1.0f / d.x, idy = 1.0f / d.y, idz = 1.0f / d.z;

    float bt = FLT_MAX_WGSL;
    Vec3 bn = {0.0f, 0.0f, 0.0f};
    float bmid = 0.0f;
    int wch = -1;

    for (int oi = 0; oi < p.n_chunks; ++oi) {
        const int ci = __ldg(order + oi);
        const float* box = p.chunks + ci * 6;
        float t0x = (__ldg(box + 0) - o.x) * idx;
        float t1x = (__ldg(box + 3) - o.x) * idx;
        float t0y = (__ldg(box + 1) - o.y) * idy;
        float t1y = (__ldg(box + 4) - o.y) * idy;
        float t0z = (__ldg(box + 2) - o.z) * idz;
        float t1z = (__ldg(box + 5) - o.z) * idz;
        float tmin = fmax_w(fmax_w(fmin_w(t0x, t1x), fmin_w(t0y, t1y)),
                            fmin_w(t0z, t1z));
        float tmax = fmin_w(fmin_w(fmax_w(t0x, t1x), fmax_w(t0y, t1y)),
                            fmax_w(t0z, t1z));
        bool live = alive && (tmin <= tmax) && (tmax >= 0.0f) && (tmin < bt);
        if (!__syncthreads_or(live)) continue;
        if (!alive) continue;

        const float prev = bt;
        const float* tri = p.tab + (size_t)ci * p.chunk * TRI_COLS;
        for (int k = 0; k < p.chunk; ++k, tri += TRI_COLS) {
            Vec3 a = {__ldg(tri + 0), __ldg(tri + 1), __ldg(tri + 2)};
            Vec3 e1 = {__ldg(tri + 3), __ldg(tri + 4), __ldg(tri + 5)};
            Vec3 e2 = {__ldg(tri + 6), __ldg(tri + 7), __ldg(tri + 8)};
            Vec3 h = cross3(d, e2);
            float det = dot3(e1, h);
            float inv_det = 1.0f / det;
            Vec3 s = sub3(o, a);
            float u = inv_det * dot3(s, h);
            Vec3 q = cross3(s, e1);
            float v = inv_det * dot3(d, q);
            float t = inv_det * dot3(e2, q);
            bool valid = (fabsf(det) >= EPSILON_TRIS)
                && (u >= 0.0f) && (u <= 1.0f)
                && (v >= 0.0f) && (u + v <= 1.0f)
                && (t >= EPSILON_TRIS) && (t < bt);
            if (valid) {
                bt = t;
                bn = {__ldg(tri + 9), __ldg(tri + 10), __ldg(tri + 11)};
                bmid = __ldg(tri + 12);
            }
        }
        // the chunk whose scan last improved best-t owns the hit
        if (bt < prev) wch = ci;
    }

    const bool hit = alive && (bt != FLT_MAX_WGSL);
    r.active = hit ? 1 : 0;
    if (!hit) return -1;

    // material resolved once per bounce from the winning mat id
    Vec3 albedo = {0.0f, 0.0f, 0.0f};
    float param = 0.0f, kind_f = 0.0f;
    for (int j = 0; j < p.n_mats; ++j) {
        if (bmid == (float)j) {
            const float* m = p.mats + j * 5;
            albedo = {__ldg(m + 0), __ldg(m + 1), __ldg(m + 2)};
            param = __ldg(m + 3);
            kind_f = __ldg(m + 4);
        }
    }

    // hit record: flat normal, NO flip, inverted front_face convention
    Vec3 point = add3(o, scale3(d, bt));
    bool front_face = dot3(bn, d) > 0.0f;
    Vec3 nd = d;
    scatter(r.state, nd, bn, front_face, param, (int)kind_f, p.flags);
    r.o = point;
    r.d = nd;
    r.atten = {r.atten.x * albedo.x * 0.7f, r.atten.y * albedo.y * 0.7f,
               r.atten.z * albedo.z * 0.7f};
    return wch;
}

// grid (Wp/tw, Hp/th, F), block th*tw.  Outputs are (F*Hp, Wp) planes in
// image order; payf holds 10 of them: o(3) d(3) atten(3) primary_dy.
__global__ void wave_first_kernel(
        Tables p, const int* __restrict__ order, CameraRow cam,
        const uint32_t* __restrict__ times, int row0, int height, int width,
        int height_pad, int width_pad, int tw, int normalize_defocus_dir,
        float* __restrict__ payf, uint32_t* __restrict__ state_out,
        int* __restrict__ active_out, int* __restrict__ wch_out) {
    const int ly = threadIdx.x / tw, lx = threadIdx.x % tw;
    const int th = blockDim.x / tw;
    const int row = blockIdx.y * th + ly;
    const int col = blockIdx.x * tw + lx;
    const size_t n = (size_t)gridDim.z * height_pad * width_pad;
    const size_t i = ((size_t)blockIdx.z * height_pad + row) * width_pad + col;

    Ray r;
    generate_ray(cam, (uint32_t)col, (uint32_t)(row + row0), height, width,
                 __ldg(times + blockIdx.z), normalize_defocus_dir != 0,
                 r.state, r.o, r.d);
    const float primary_dy = r.d.y;
    r.atten = {1.0f, 1.0f, 1.0f};
    r.active = 1;
    const int wch = trace_bounce(p, order, r);

    payf[0 * n + i] = r.o.x;
    payf[1 * n + i] = r.o.y;
    payf[2 * n + i] = r.o.z;
    payf[3 * n + i] = r.d.x;
    payf[4 * n + i] = r.d.y;
    payf[5 * n + i] = r.d.z;
    payf[6 * n + i] = r.atten.x;
    payf[7 * n + i] = r.atten.y;
    payf[8 * n + i] = r.atten.z;
    payf[9 * n + i] = primary_dy;
    state_out[i] = r.state;
    active_out[i] = r.active;
    wch_out[i] = wch;
}

// grid (Wp/tw, Hp/th, F), block th*tw, as wave_first_kernel.  od holds 6
// (F*Hp, Wp) planes: o(3) d(3).  Padding pixels are generated too.
__global__ void wave_raygen_kernel(
        CameraRow cam, const uint32_t* __restrict__ times, int row0,
        int height, int width, int height_pad, int width_pad, int tw,
        int normalize_defocus_dir, float* __restrict__ od,
        float* __restrict__ pdy_out, uint32_t* __restrict__ state_out) {
    const int ly = threadIdx.x / tw, lx = threadIdx.x % tw;
    const int th = blockDim.x / tw;
    const int row = blockIdx.y * th + ly;
    const int col = blockIdx.x * tw + lx;
    const size_t n = (size_t)gridDim.z * height_pad * width_pad;
    const size_t i = ((size_t)blockIdx.z * height_pad + row) * width_pad + col;

    uint32_t state;
    Vec3 o, d;
    generate_ray(cam, (uint32_t)col, (uint32_t)(row + row0), height, width,
                 __ldg(times + blockIdx.z), normalize_defocus_dir != 0,
                 state, o, d);
    od[0 * n + i] = o.x;
    od[1 * n + i] = o.y;
    od[2 * n + i] = o.z;
    od[3 * n + i] = d.x;
    od[4 * n + i] = d.y;
    od[5 * n + i] = d.z;
    pdy_out[i] = d.y;
    state_out[i] = state;
}

// grid n / tile, block tile.  pay is (9, n): o(3) d(3) atten(3); pay, state
// and active are updated in place.  tile_order is (n_tiles * n_chunks).
__global__ void wave_bounce_kernel(
        Tables p, const int* __restrict__ tile_order, size_t n, int n_bounces,
        float* __restrict__ pay, uint32_t* __restrict__ state,
        int* __restrict__ active, int* __restrict__ wch_out) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int* order = tile_order + (size_t)blockIdx.x * p.n_chunks;

    Ray r;
    r.state = state[i];
    r.o = {pay[0 * n + i], pay[1 * n + i], pay[2 * n + i]};
    r.d = {pay[3 * n + i], pay[4 * n + i], pay[5 * n + i]};
    r.atten = {pay[6 * n + i], pay[7 * n + i], pay[8 * n + i]};
    r.active = active[i];

    int wch = -1;
    for (int b = 0; b < n_bounces; ++b) {
        // whole-tile skip: sorted dead rays cluster into all-dead tiles,
        // and a tile with no live ray stays so for the remaining bounces
        if (!__syncthreads_or(r.active > 0)) break;
        wch = trace_bounce(p, order, r);
    }

    pay[0 * n + i] = r.o.x;
    pay[1 * n + i] = r.o.y;
    pay[2 * n + i] = r.o.z;
    pay[3 * n + i] = r.d.x;
    pay[4 * n + i] = r.d.y;
    pay[5 * n + i] = r.d.z;
    pay[6 * n + i] = r.atten.x;
    pay[7 * n + i] = r.atten.y;
    pay[8 * n + i] = r.atten.z;
    state[i] = r.state;
    active[i] = r.active;
    wch_out[i] = wch;
}

}  // namespace rt

// ---- plain C interface (loaded with ctypes) ---------------------------------
// Pointers are device pointers except ``cam`` (20 host floats).  Each function
// launches on ``stream`` and returns cudaGetLastError() as an int.

extern "C" int rt_wave_first(
        const float* tab, const float* mats, const float* chunks,
        const int* order, const float* cam, const uint32_t* times, int row0,
        float* payf, uint32_t* state, int* active, int* wch, int n_chunks,
        int chunk, int n_mats, int height, int width, int height_pad,
        int width_pad, int n_frames, int th, int tw,
        int normalize_defocus_dir, int normalize_reflect_in, int has_metal,
        int has_dielectric, void* stream) {
    rt::Tables p = {tab, mats, chunks, n_chunks, chunk, n_mats,
                    {normalize_reflect_in, has_metal, has_dielectric}};
    rt::CameraRow row;
    for (int c = 0; c < 20; ++c) row.v[c] = cam[c];
    dim3 grid(width_pad / tw, height_pad / th, n_frames);
    rt::wave_first_kernel<<<grid, th * tw, 0, (cudaStream_t)stream>>>(
        p, order, row, times, row0, height, width, height_pad, width_pad, tw,
        normalize_defocus_dir, payf, state, active, wch);
    return (int)cudaGetLastError();
}

extern "C" int rt_wave_bounce(
        const float* tab, const float* mats, const float* chunks,
        const int* tile_order, float* pay, uint32_t* state, int* active,
        int* wch, long long n, int tile, int n_bounces, int n_chunks,
        int chunk, int n_mats, int normalize_reflect_in, int has_metal,
        int has_dielectric, void* stream) {
    rt::Tables p = {tab, mats, chunks, n_chunks, chunk, n_mats,
                    {normalize_reflect_in, has_metal, has_dielectric}};
    rt::wave_bounce_kernel<<<(unsigned)(n / tile), tile, 0,
                             (cudaStream_t)stream>>>(
        p, tile_order, (size_t)n, n_bounces, pay, state, active, wch);
    return (int)cudaGetLastError();
}

extern "C" int rt_wave_raygen(
        const float* cam, const uint32_t* times, int row0, float* od,
        float* pdy, uint32_t* state, int height, int width, int height_pad,
        int width_pad, int n_frames, int th, int tw,
        int normalize_defocus_dir, void* stream) {
    rt::CameraRow row;
    for (int c = 0; c < 20; ++c) row.v[c] = cam[c];
    dim3 grid(width_pad / tw, height_pad / th, n_frames);
    rt::wave_raygen_kernel<<<grid, th * tw, 0, (cudaStream_t)stream>>>(
        row, times, row0, height, width, height_pad, width_pad, tw,
        normalize_defocus_dir, od, pdy, state);
    return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
