// Fused sphere path-trace kernels for Hopper (sm_90a).
//
//   spheres_kernel<false>   replaces rt/kernels/sphere_kernel.py:_kernel
//                           (whole frame, flat scan: raygen, sample loop,
//                           bounce loop, closest-hit scan over every row,
//                           scatter, sky, divide by the sample count)
//   spheres_kernel<true>    replaces
//                           rt/kernels/sphere_kernel.py:_kernel_record
//                           (the same at one sample per pixel, and the
//                           winning row of every bounce, -1 on a miss, for
//                           the path-replay gradients)
//   spheres_chunked_kernel  replaces
//                           rt/kernels/sphere_kernel.py:_kernel_chunked
//                           (the same for larger scenes: the table in Morton
//                           order in chunks of 32, one box per chunk, visited
//                           front to back from the eye)
//
// One launch traces one frame; the only device-memory traffic is the tables
// in and three color words per pixel out.
//
// The TPU kernels hold every quantity as a (th, tw) plane and carry the
// winning sphere's attributes through the scan as a chain of selects.  Here
// one thread owns one pixel, the scan keeps only the best t and the winning
// row's index, and the row is read once after the scan.  Both give the same
// hit because `t < best` is strict and the rows are scanned in the same
// ascending order.
//
// Flat kernel: the table and the kinds are staged in dynamic shared memory
// (9 words a row, sized by the launch; at most 1024 rows, which stays under
// the 48 KB a block gets without opting in to more; a launch with more rows
// is refused) and every thread reads the same row at the same time, a
// broadcast.  A ray that misses stops: a dead ray passes through a bounce
// unchanged in the TPU kernel, whose whole-tile early exit only skips work,
// so the image does not depend on the tile.  The recorder then fills the
// index planes of the bounces it did not run with -1; the TPU recorder runs
// every bounce and its dead lanes write the same -1.
//
// Chunked kernel: one block is one (th, tw) pixel tile, and the tile is the
// unit of the chunk cull, as in the TPU kernel: each thread tests the
// chunk's box, and if ANY live thread of the block enters it nearer than
// its best hit (__syncthreads_or) then EVERY live thread scans its 32 rows,
// also one whose own box test failed.  The image depends on that union at
// box-surface roundings, so it is kept.  A dead thread keeps voting (false)
// until the whole block is dead; padding pixels trace and vote like any
// other; padding rows have radius -1e30 (r*r = +inf, t = -inf) and miss
// without a NaN.
//
// Bound: operations.  A (ray, sphere) pair costs ~23 f32 operations on 16
// bytes of row that the whole block shares; a pixel writes 12 bytes.
//
// Built with -fmad=false: the plain versions round every multiply and add,
// so the kernels must not contract them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rt_device.cuh"

namespace rt {

constexpr int SPH_COLS = 8;  // centre(3) radius albedo(3) material parameter
constexpr int MAX_STAGED_SPHERES = 1024;  // rows the flat kernels stage

struct Quadratic {
    Vec3 o, d;
    float two_a, four_a;  // hoisted: d is fixed within a bounce
};

__device__ __forceinline__ Quadratic hoist(const Ray& r) {
    float a = dot3(r.d, r.d);
    return {r.o, r.d, 2.0f * a, 4.0f * a};
}

// One (ray, sphere) pair: near root only, -1 on a negative discriminant,
// strict 0 < t < best.
__device__ __forceinline__ void scan_sphere(const float* row, int si,
                                            const Quadratic& q, float& bt,
                                            int& bidx) {
    Vec3 oc = sub3(q.o, {row[0], row[1], row[2]});
    float r = row[3];
    float b = 2.0f * dot3(oc, q.d);
    float cc = dot3(oc, oc) - r * r;
    float disc = b * b - q.four_a * cc;
    // maximum(disc, 0) that keeps a NaN, as a select (fmaxf would drop it)
    float sq = sqrtf(disc < 0.0f ? 0.0f : disc);
    float t = (-b - sq) / q.two_a;
    if (disc < 0.0f) t = -1.0f;
    if (t > 0.0f && t < bt) {
        bt = t;
        bidx = si;
    }
}

// Hit record from the winning row, scatter, carry update.
__device__ __forceinline__ void resolve_hit(const float* row, int kind,
                                            const ScatterFlags& flags,
                                            float bt, Ray& r) {
    Vec3 c = {row[0], row[1], row[2]};
    float br = row[3];
    Vec3 albedo = {row[4], row[5], row[6]};
    Vec3 point = add3(r.o, scale3(r.d, bt));
    Vec3 normal = {(point.x - c.x) / br, (point.y - c.y) / br,
                   (point.z - c.z) / br};
    bool front_face = dot3(r.d, normal) < 0.0f;
    if (!front_face) normal = neg3(normal);
    Vec3 nd = r.d;
    scatter(r.state, nd, normal, front_face, row[7], kind, flags);
    r.o = point;
    r.d = nd;
    // (atten * albedo) * 0.7, in that order
    r.atten = {r.atten.x * albedo.x * 0.7f, r.atten.y * albedo.y * 0.7f,
               r.atten.z * albedo.z * 0.7f};
}

// grid (Wp/tw, Hp/th), block th*tw.  out is (3, Hp, Wp).  Dynamic shared
// memory: n_spheres rows of SPH_COLS floats, then n_spheres kinds.
// RECORD: idx is (bounces, Hp, Wp) and gets the winning row of every bounce,
// -1 from the thread's miss on (the launch is made with spp 1).
template <bool RECORD>
__global__ void spheres_kernel(const float* __restrict__ tab,
                               const int* __restrict__ kinds, int n_spheres,
                               Frame f, float* __restrict__ out,
                               int* __restrict__ idx) {
    extern __shared__ float s_tab[];
    int* s_kind = reinterpret_cast<int*>(s_tab + n_spheres * SPH_COLS);
    for (int i = threadIdx.x; i < n_spheres * SPH_COLS; i += blockDim.x)
        s_tab[i] = tab[i];
    for (int i = threadIdx.x; i < n_spheres; i += blockDim.x)
        s_kind[i] = kinds[i];
    __syncthreads();

    Pixel p = primary_ray(f);
    const size_t plane = (size_t)f.height_pad * f.width_pad;
    const size_t pix = (size_t)p.row * f.width_pad + p.col;
    Vec3 acc = {0.0f, 0.0f, 0.0f};
    for (int s = 0; s < f.spp; ++s) {
        Ray r = {p.state, p.o, p.d, {1.0f, 1.0f, 1.0f}, 1};
        int b = 0;
        for (; b < f.bounces; ++b) {
            const Quadratic q = hoist(r);
            float bt = FLT_MAX_WGSL;
            int bidx = -1;
            for (int si = 0; si < n_spheres; ++si)
                scan_sphere(s_tab + si * SPH_COLS, si, q, bt, bidx);
            if (bt == FLT_MAX_WGSL) break;  // escaped to the sky
            if (RECORD) idx[b * plane + pix] = bidx;
            resolve_hit(s_tab + bidx * SPH_COLS, s_kind[bidx], f.flags, bt,
                        r);
        }
        // the planes of the bounces the thread did not run
        if (RECORD)
            for (; b < f.bounces; ++b) idx[b * plane + pix] = -1;
        p.state = r.state;
        Vec3 col = sample_color(f, p, r);
        acc = f.spp > 1 ? add3(acc, col) : col;
    }
    store_color(f, p, acc, out);
}

// grid (Wp/tw, Hp/th), block th*tw = one tile.  order: n_chunks visit
// entries, shared by all tiles.  EVERY thread of the block runs the same
// number of bounces and chunk steps (block-wide votes inside).
__global__ void spheres_chunked_kernel(
        const float* __restrict__ tab, const int* __restrict__ kinds,
        const float* __restrict__ chunks, const int* __restrict__ order,
        int n_chunks, int chunk, Frame f, float* __restrict__ out) {
    Pixel p = primary_ray(f);
    Vec3 acc = {0.0f, 0.0f, 0.0f};
    for (int s = 0; s < f.spp; ++s) {
        Ray r = {p.state, p.o, p.d, {1.0f, 1.0f, 1.0f}, 1};
        for (int b = 0; b < f.bounces; ++b) {
            // block-uniform exit once every ray of the tile has escaped
            if (!__syncthreads_or(r.active > 0)) break;
            const bool alive = r.active > 0;
            const Quadratic q = hoist(r);
            const float idx = 1.0f / r.d.x, idy = 1.0f / r.d.y,
                        idz = 1.0f / r.d.z;
            float bt = FLT_MAX_WGSL;
            int bidx = -1;
            for (int oi = 0; oi < n_chunks; ++oi) {
                const int ci = __ldg(order + oi);
                const float* box = chunks + ci * 6;
                float t0x = (__ldg(box + 0) - r.o.x) * idx;
                float t1x = (__ldg(box + 3) - r.o.x) * idx;
                float t0y = (__ldg(box + 1) - r.o.y) * idy;
                float t1y = (__ldg(box + 4) - r.o.y) * idy;
                float t0z = (__ldg(box + 2) - r.o.z) * idz;
                float t1z = (__ldg(box + 5) - r.o.z) * idz;
                float tmin = fmax_w(
                    fmax_w(fmin_w(t0x, t1x), fmin_w(t0y, t1y)),
                    fmin_w(t0z, t1z));
                float tmax = fmin_w(
                    fmin_w(fmax_w(t0x, t1x), fmax_w(t0y, t1y)),
                    fmax_w(t0z, t1z));
                bool live = alive && (tmin <= tmax) && (tmax >= 0.0f)
                    && (tmin < bt);
                if (!__syncthreads_or(live)) continue;
                if (!alive) continue;  // its scan would be discarded
                const int lo = ci * chunk;
                for (int k = 0; k < chunk; ++k)
                    scan_sphere(tab + (size_t)(lo + k) * SPH_COLS, lo + k, q,
                                bt, bidx);
            }
            const bool hit = alive && (bt != FLT_MAX_WGSL);
            r.active = hit ? 1 : 0;
            if (hit)
                resolve_hit(tab + (size_t)bidx * SPH_COLS, __ldg(kinds + bidx),
                            f.flags, bt, r);
        }
        p.state = r.state;
        Vec3 col = sample_color(f, p, r);
        acc = f.spp > 1 ? add3(acc, col) : col;
    }
    store_color(f, p, acc, out);
}

}  // namespace rt

// ---- plain C interface (loaded with ctypes) ---------------------------------
// Pointers are device pointers except ``cam`` (20 host floats).  Each function
// launches on ``stream`` and returns cudaGetLastError() as an int.

// out: (3, Hp, Wp) f32.  idx: (bounces, Hp, Wp) i32 for the recorder (which
// is launched with spp 1), or null for the render kernel.
extern "C" int rt_spheres(
        const float* tab, const int* kinds, const float* cam,
        unsigned int time, float* out, int* idx, int n_spheres, int height,
        int width, int height_pad, int width_pad, int th, int tw, int bounces,
        int spp, int normalize_defocus_dir, int normalize_reflect_in,
        int has_metal, int has_dielectric, int sky_from_final_dir,
        void* stream) {
    if (n_spheres < 1 || n_spheres > rt::MAX_STAGED_SPHERES)
        return (int)cudaErrorInvalidValue;
    rt::Frame f = rt::make_frame(
        cam, time, 0, height, width, height_pad, width_pad, tw, bounces, spp,
        normalize_defocus_dir, normalize_reflect_in, has_metal,
        has_dielectric, sky_from_final_dir);
    const size_t shared = (size_t)n_spheres * (rt::SPH_COLS + 1) * 4;
    dim3 grid(width_pad / tw, height_pad / th);
    if (idx)
        rt::spheres_kernel<true><<<grid, th * tw, shared,
                                   (cudaStream_t)stream>>>(
            tab, kinds, n_spheres, f, out, idx);
    else
        rt::spheres_kernel<false><<<grid, th * tw, shared,
                                    (cudaStream_t)stream>>>(
            tab, kinds, n_spheres, f, out, nullptr);
    return (int)cudaGetLastError();
}

extern "C" int rt_spheres_chunked(
        const float* tab, const int* kinds, const float* chunks,
        const int* order, const float* cam, unsigned int time, float* out,
        int n_chunks, int chunk, int height, int width, int height_pad,
        int width_pad, int th, int tw, int bounces, int spp,
        int normalize_defocus_dir, int normalize_reflect_in, int has_metal,
        int has_dielectric, int sky_from_final_dir, void* stream) {
    rt::Frame f = rt::make_frame(
        cam, time, 0, height, width, height_pad, width_pad, tw, bounces, spp,
        normalize_defocus_dir, normalize_reflect_in, has_metal,
        has_dielectric, sky_from_final_dir);
    dim3 grid(width_pad / tw, height_pad / th);
    rt::spheres_chunked_kernel<<<grid, th * tw, 0, (cudaStream_t)stream>>>(
        tab, kinds, chunks, order, n_chunks, chunk, f, out);
    return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
