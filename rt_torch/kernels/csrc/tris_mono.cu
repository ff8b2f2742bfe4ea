// Whole-frame triangle path-trace kernels for Hopper (sm_90a).
//
//   tris_mono_kernel<false>  replaces rt/kernels/tris_kernel.py:_kernel
//                            (one launch traces a frame: raygen, sample loop,
//                            bounce loop, chunk-culled closest-hit scan,
//                            scatter, sky, divide by the sample count)
//   tris_mono_kernel<true>   replaces rt/kernels/tris_kernel.py:_kernel_record
//                            (the same at one sample per pixel, and the
//                            winning row of the triangle table of every
//                            bounce, -1 on a miss or a dead ray, for the
//                            path-replay gradients)
//
// Both run the cull loop of the wavefront kernels (tris_trace.cuh), as the
// TPU kernels all run one _trace_bounce.  One block is one (th, tw) pixel
// tile for the whole frame, and every bounce visits the chunks in one order,
// front to back from the camera eye (the wavefront kernels order per tile
// from bounce 1 on, so the two paths may differ where a ray hits two chunks
// at exactly the same t).
//
// Every thread of a block must reach every block-wide vote, so the bounce
// loop's exit is a vote itself (the TPU kernel's lax.cond(jnp.any(active))):
// a dead thread keeps voting false until the whole tile is dead.  The TPU
// recorder has no such exit; here it keeps it, and the index planes of the
// bounces a tile did not run are filled with -1, which is what its dead
// lanes would have written.
//
// Bound: operations, as for the wavefront kernels: ~46 f32 operations per
// (ray, triangle) pair; a pixel writes 12 bytes, the recorder 4 more per
// bounce.  After bounce 0 a pixel tile's rays scatter, the tile's union
// touches most chunks, and the cull prunes little; and the dead rays stay in
// their pixels' threads: on Suzanne at 128x128, 8 bounces, from bounce 2 on
// 16-32 % of the rays live, but 66-83 % of the warps hold one
// (PERF.md, `python -m rt_torch.measure occupancy`).
//
// Design: packed_scan (tris_trace.cuh, point 5).  Each bounce the block
// packs its live rays into its first warps and scans them there, at one
// thread a ray, and at more lanes (up to PACK_MAX_LANES) where few rays
// live; a ray's own thread resolves its hit from the table row the scan
// returns and scatters it.  These choices were timed on an H100 against two
// lanes a ray in blocks of 2 x the tile and against no packing, which were
// slower (PERF.md).
//
// Built with -fmad=false: the plain version rounds every multiply and add,
// so the kernel must not contract them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tris_trace.cuh"

namespace rt {

// grid (Wp/tw, Hp/th), block th*tw = one tile, a thread a pixel.  Dynamic
// shared memory: th*tw slots of 32 bytes.  order: n_chunks visit entries,
// shared by all tiles and bounces.  out is (3, Hp, Wp); idx is (bounces, Hp,
// Wp) with RECORD, unused without.
template <bool RECORD, bool BOUNDED>
__global__ void __launch_bounds__(max_threads(BOUNDED, 1))
tris_mono_kernel(Tables t, const int* __restrict__ order, Frame f,
                 float* __restrict__ out, int* __restrict__ idx) {
    extern __shared__ float4 slots[];
    Pixel p = primary_ray(f);
    const size_t plane = (size_t)f.height_pad * f.width_pad;
    const size_t pix = (size_t)p.row * f.width_pad + p.col;
    Vec3 acc = {0.0f, 0.0f, 0.0f};
    for (int s = 0; s < f.spp; ++s) {
        Ray r = {p.state, p.o, p.d, {1.0f, 1.0f, 1.0f}, 1};
        int b = 0;
        for (; b < f.bounces; ++b) {
            const bool alive = r.active > 0;
            float bt = FLT_MAX_WGSL;
            int win = -1;
            // block-uniform exit once every ray of the tile has escaped
            if (!packed_scan<Tri>(t.tab, t.chunks, t.n_chunks, order, alive,
                                  r.o, r.d, slots, bt, win))
                break;
            const bool hit = alive && (bt != FLT_MAX_WGSL);
            r.active = hit ? 1 : 0;
            if (hit) {
                const float* row = t.tab + (size_t)win * TRI_COLS;
                scatter_tri(t, r, bt,
                            {__ldg(row + 9), __ldg(row + 10), __ldg(row + 11)},
                            __ldg(row + 12));
            }
            if (RECORD) idx[b * plane + pix] = hit ? win : -1;
        }
        // the planes of the bounces the tile did not run
        if (RECORD)
            for (; b < f.bounces; ++b) idx[b * plane + pix] = -1;
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
// (cudaErrorInvalidValue, launching nothing, when ``chunk`` is not CHUNK).

// out: (3, Hp, Wp) f32.  idx: (bounces, Hp, Wp) i32 for the recorder (which
// is launched with spp 1 and row0 0), or null for the render kernel.
extern "C" int rt_tris_mono(
        const float* tab, const float* mats, const float* chunks,
        const int* order, const float* cam, unsigned int time, int row0,
        float* out, int* idx, int n_chunks, int chunk, int n_mats,
        int height, int width, int height_pad, int width_pad, int th, int tw,
        int bounces, int spp, int normalize_defocus_dir,
        int normalize_reflect_in, int has_metal, int has_dielectric,
        int sky_from_final_dir, void* stream) {
    if (chunk != rt::CHUNK) return (int)cudaErrorInvalidValue;
    rt::Tables t = {tab, mats, chunks, n_chunks, n_mats,
                    {normalize_reflect_in, has_metal, has_dielectric}};
    rt::Frame f = rt::make_frame(
        cam, time, row0, height, width, height_pad, width_pad, tw, bounces,
        spp, normalize_defocus_dir, normalize_reflect_in, has_metal,
        has_dielectric, sky_from_final_dir);
    dim3 grid(width_pad / tw, height_pad / th);
    const int rays = th * tw;
    const bool bounded = rays <= rt::TRACE_BLOCK;
    const size_t shared = (size_t)rays * 2 * sizeof(float4);
    auto kernel = idx ? (bounded ? rt::tris_mono_kernel<true, true>
                                 : rt::tris_mono_kernel<true, false>)
                      : (bounded ? rt::tris_mono_kernel<false, true>
                                 : rt::tris_mono_kernel<false, false>);
    kernel<<<grid, rays, shared, (cudaStream_t)stream>>>(t, order, f, out,
                                                         idx);
    return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
