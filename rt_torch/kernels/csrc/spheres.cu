// Fused sphere path-trace kernels for Hopper (sm_90a).
//
//   spheres_kernel<false>   replaces rt/kernels/sphere_kernel.py:_kernel
//                           (whole frame, flat scan: raygen, the primary
//                           ray's closest hit, sample loop, bounce loop,
//                           closest-hit scan over every row, scatter, sky,
//                           divide by the sample count)
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
// broadcast: centre and radius as one 128-bit load, the pair test
// hit_sphere (tris_trace.cuh) with its exact early exits.  A ray that
// misses stops: a dead ray passes through a bounce unchanged in the TPU
// kernel, whose whole-tile early exit only skips work, so the image does
// not depend on the tile.  The recorder then fills the
// index planes of the bounces it did not run with -1; the TPU recorder runs
// every bounce and its dead lanes write the same -1.  Every sample traces
// the pixel's primary ray anew, so its closest hit is the same in each: it
// is found once, before the sample loop, and a sample's first bounce starts
// at its resolve and scatter (at 64 samples and 10 bounces 1.05x; at one
// bounce 1.7x).  A thread owns one pixel of a (th, tw) tile for the whole
// launch, and its warp runs each sample in step, as long as its longest
// path.  Two schedules that fill those idle lanes were timed against this
// on an H100 and lost: a persistent grid whose lanes took new pixels as
// their paths ended, slower for the render kernel (0.85-0.98x) and the
// recorder (0.78-0.89x), its bookkeeping and registers costing what the
// idle lanes did; and one loop over a pixel's samples' bounces, a lane
// starting its next sample as soon as its path ended, which took 1.27x
// fewer warp turns on the dielectric frame (kernels/sphere_schedule.py)
// but ran no faster (0.98-1.01x) with 4 more registers: there most of the
// time goes to the pixels whose refracted rays re-hit their sphere until
// the bounces run out in nearly every sample, and no schedule of a pixel's
// own samples shortens that chain (PERF.md).
//
// Chunked kernel: one block is one (th, tw) pixel tile, and the tile is the
// unit of the chunk cull, as in the TPU kernel: if ANY live ray of the block
// enters a chunk's box nearer than its best hit, EVERY live ray scans its 32
// rows, also one whose own box test failed.  The image depends on that union
// at box-surface roundings, so it is kept.  A dead thread keeps voting
// (false) until the whole block is dead; padding pixels trace and vote like
// any other; padding rows have radius -1e30 (r*r = +inf, t = -inf) and miss
// without a NaN.  It runs the cull loop of the triangle kernels over
// spheres (tris_trace.cuh: cull_scan with the Sph primitive, packed_scan):
//   - the chunk votes batched, 32 visit entries a barrier (cover's 16
//     entries are one batch), then the exact vote on the tile's candidate
//     bits only, the slab test's min/max as fminf/fmaxf (exact in every
//     comparison);
//   - a candidate chunk's centres and radii staged in shared memory, one
//     16-byte row a sphere, double-buffered, so a pair reads one 128-bit
//     broadcast; only candidates are staged, so shared memory does not grow
//     with the sphere count (the albedo and parameter are read from the
//     table once a bounce, for the winner);
//   - a scan unrolled over the chunk's 32 rows, with the exact early exits
//     of hit_sphere (most pairs miss at the discriminant);
//   - the live rays packed into the block's first warps each bounce, at
//     one thread a ray, and at more lanes (up to PACK_MAX_LANES) where few
//     live, merged by least (t, index); the ray's own thread resolves and
//     scatters it from the winning row the scan returns.
// These choices were timed on an H100 against two lanes a ray, no packing
// and a one-phase scan, which were slower (PERF.md).
//
// Bound: operations.  A (ray, sphere) pair costs ~23 f32 operations on 16
// bytes of row that the whole block shares, a hit's resolve and scatter 45
// or more; a pixel writes 12 bytes.  On
// cover, with a thread a pixel, the warps issued ~2.9x the pairs the bound
// counts: from bounce 2 on 3-27 % of the rays live, in 42-74 % of the warps
// (the plain version's carry at 320x180, PERF.md).
//
// Built with -fmad=false: the plain versions round every multiply and add,
// so the kernels must not contract them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tris_trace.cuh"

namespace rt {

constexpr int MAX_STAGED_SPHERES = 1024;  // rows the flat kernels stage

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

// The closest hit over the first n staged rows, each read by every thread
// at once (a broadcast), in ascending order: t < bt is strict, so the first
// of equal t wins.
__device__ __forceinline__ void flat_scan(const float4* rows, int n,
                                          const Quadratic& q, float& bt,
                                          int& bidx) {
    for (int si = 0; si < n; ++si) {
        float t;
        if (hit_sphere(rows[si * (SPH_COLS / 4)], q, bt, t)) {
            bt = t;
            bidx = si;
        }
    }
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
    extern __shared__ float4 s_dyn[];
    float* s_tab = reinterpret_cast<float*>(s_dyn);
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
    // every sample traces the same primary ray: its closest hit, found once
    float bt0 = FLT_MAX_WGSL;
    int bidx0 = -1;
    if (f.bounces > 0)
        flat_scan(s_dyn, n_spheres, Sph::ray(p.o, p.d), bt0, bidx0);
    for (int s = 0; s < f.spp; ++s) {
        Ray r = {p.state, p.o, p.d, {1.0f, 1.0f, 1.0f}, 1};
        float bt = bt0;
        int bidx = bidx0;
        int b = 0;
        for (; b < f.bounces; ++b) {
            if (bt == FLT_MAX_WGSL) break;  // escaped to the sky
            if (RECORD) idx[b * plane + pix] = bidx;
            resolve_hit(s_tab + bidx * SPH_COLS, s_kind[bidx], f.flags, bt,
                        r);
            // the next bounce's closest hit
            bt = FLT_MAX_WGSL;
            bidx = -1;
            if (b + 1 < f.bounces)
                flat_scan(s_dyn, n_spheres, Sph::ray(r.o, r.d), bt, bidx);
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

// grid (Wp/tw, Hp/th), block th*tw = one tile, a thread a pixel.  Dynamic
// shared memory: th*tw slots of 32 bytes.  order: n_chunks visit entries,
// shared by all tiles.  EVERY thread of the block runs the same number of
// bounces (block-wide votes inside).
template <bool BOUNDED>
__global__ void __launch_bounds__(max_threads(BOUNDED, 1))
spheres_chunked_kernel(const float* __restrict__ tab,
                       const int* __restrict__ kinds,
                       const float* __restrict__ chunks,
                       const int* __restrict__ order, int n_chunks, Frame f,
                       float* __restrict__ out) {
    extern __shared__ float4 s_dyn[];
    Pixel p = primary_ray(f);
    Vec3 acc = {0.0f, 0.0f, 0.0f};
    for (int s = 0; s < f.spp; ++s) {
        Ray r = {p.state, p.o, p.d, {1.0f, 1.0f, 1.0f}, 1};
        for (int b = 0; b < f.bounces; ++b) {
            const bool alive = r.active > 0;
            float bt = FLT_MAX_WGSL;
            int win = -1;
            // block-uniform exit once every ray of the tile has escaped
            if (!packed_scan<Sph>(tab, chunks, n_chunks, order, alive, r.o,
                                  r.d, s_dyn, bt, win))
                break;
            const bool hit = alive && (bt != FLT_MAX_WGSL);
            r.active = hit ? 1 : 0;
            if (hit)
                resolve_hit(tab + (size_t)win * SPH_COLS, __ldg(kinds + win),
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
// launches on ``stream`` and returns cudaGetLastError() as an int
// (cudaErrorInvalidValue, launching nothing, on a row count the flat kernels
// do not stage or a ``chunk`` that is not CHUNK).

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
    if (chunk != rt::CHUNK) return (int)cudaErrorInvalidValue;
    rt::Frame f = rt::make_frame(
        cam, time, 0, height, width, height_pad, width_pad, tw, bounces, spp,
        normalize_defocus_dir, normalize_reflect_in, has_metal,
        has_dielectric, sky_from_final_dir);
    dim3 grid(width_pad / tw, height_pad / th);
    const int rays = th * tw;
    const bool bounded = rays <= rt::TRACE_BLOCK;
    const size_t shared = (size_t)rays * 2 * sizeof(float4);
    auto kernel = bounded ? rt::spheres_chunked_kernel<true>
                          : rt::spheres_chunked_kernel<false>;
    kernel<<<grid, rays, shared, (cudaStream_t)stream>>>(
        tab, kinds, chunks, order, n_chunks, f, out);
    return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
