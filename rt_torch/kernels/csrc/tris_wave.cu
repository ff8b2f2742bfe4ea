// Wavefront triangle path-trace kernels for Hopper (sm_90a).
//
//   wave_first_kernel   replaces rt/kernels/tris_kernel.py:_wave_first_kernel
//                       (raygen fused with bounce 0 over pixel tiles)
//   wave_bounce_kernel  replaces rt/kernels/tris_kernel.py:_wave_bounce_kernel
//                       (n_bounces fused bounces over one tile of the sorted
//                       ray stream, payload updated in place)
//   wave_first_kernel<true, *>, wave_bounce_kernel<true, *>
//                       replace the same two with track_idx=True, as
//                       render_color_tris_wave_record launches them (K10a,
//                       K10b): the same bounce, and per bounce the winning
//                       row of the triangle table, -1 on a miss or a dead
//                       ray, for the path-replay gradients on large meshes.
//                       The <false, *> instances are the render kernels:
//                       the flag only adds the index stores.
//   wave_raygen_kernel  replaces rt/kernels/tris_kernel.py:_wave_raygen_kernel
//                       (primary rays only, for more than one sample per
//                       pixel: every sample's bounces start from them)
//
// The first two call one trace_bounce() (tris_trace.cuh), as both TPU
// kernels call _trace_bounce, so they agree per ray.  The raygen kernel calls the same
// generate_ray() as wave_first_kernel; it writes 8 words per pixel and is
// bound by bytes.
//
// What the TPU kernel does on (th, tw) planes with selects, this does with
// one thread (the bounce kernel: TRACE_LANES threads) per ray; one block
// is one tile.  The tile is the unit of two decisions that change which
// (ray, triangle) pairs are tested, so it is kept: a chunk of 32 triangles
// is scanned only when some live ray of the TILE enters its box nearer than
// its best hit (the TPU's lax.cond(jnp.any(live)) becomes a block vote), and
// chunks are visited in a per-tile front-to-back order read at blockIdx *
// n_chunks.  Inside a live chunk every live ray of the tile scans all 32
// triangles in ascending index with strict t < best, also a ray whose own
// box test failed: that is what the plain version does, and it keeps the
// image equal at equal tile shape.  Rays that are already dead skip the
// scan; their result is discarded by the hit mask in either version.
//
// Bound: operations.  The scan does 46 f32 operations per (ray, triangle)
// pair and the box test 24 per (ray, chunk), while the payload is 23 words
// per ray per launch (the recorder writes one more word per ray and
// bounce).  trace_bounce (tris_trace.cuh) votes once a batch of 32 boxes
// and once a candidate chunk, stages a candidate's triangles in shared
// memory and leaves a pair at its first failed test.  What is left bounds
// both kernels: the issue rate of ~80 instructions a warp-pair and ~30 a
// box test, and, after a bounce, the latency of the heaviest tiles, which
// the bounce kernel's lane groups cut.
//
// Launch bounds: tiles of at most TRACE_BLOCK rays (the default 8x16) take
// the BOUNDED instances, __launch_bounds__(lanes * TRACE_BLOCK); larger
// tiles the ones bounded by 1024 threads and one lane a ray.  No minimum of
// blocks an SM: the kernels compile to 53-60 registers a thread (64 with
// the index stores at two lanes) with no spills, and a minimum that
// forces 40 or 48 registers spills and was slower on an H100 (PERF.md).
//
// Built with -fmad=false: the plain version rounds every multiply and add,
// so the kernel must not contract them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tris_trace.cuh"

namespace rt {

// lanes a ray of the bounded bounce kernel (trace_bounce's LANES)
constexpr int TRACE_LANES = 2;

// An instance is BOUNDED for tiles of at most TRACE_BLOCK rays: the bounce
// kernel then runs TRACE_LANES lanes a ray, so blocks of that many times
// tile threads; else one lane a ray, any tile the wrappers allow.
__host__ __device__ constexpr int bounce_lanes(bool bounded) {
    return bounded ? TRACE_LANES : 1;
}

// grid (Wp/tw, Hp/th, F), block th*tw.  Outputs are (F*Hp, Wp) planes in
// image order; payf holds 10 of them: o(3) d(3) atten(3) primary_dy.
// TRACK_IDX (the recorder, K10a): idx_out gets the winning row of the
// triangle table, -1 on a miss; unused without it.
template <bool TRACK_IDX, bool BOUNDED>
__global__ void __launch_bounds__(max_threads(BOUNDED, 1))
wave_first_kernel(
        Tables p, const int* __restrict__ order, CameraRow cam,
        const uint32_t* __restrict__ times, int row0, int height, int width,
        int height_pad, int width_pad, int tw, int normalize_defocus_dir,
        float* __restrict__ payf, uint32_t* __restrict__ state_out,
        int* __restrict__ active_out, int* __restrict__ wch_out,
        int* __restrict__ idx_out) {
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
    int tid;
    const int wch = trace_bounce<TRACK_IDX>(p, order, r, tid);

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
    if (TRACK_IDX) idx_out[i] = tid;
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
// TRACK_IDX (the recorder, K10b): idx_out is (n_bounces, n) and plane b gets
// bounce b's winning row of the triangle table, -1 on a miss, on a dead ray
// and in every bounce a tile skipped; unused without it.
template <bool TRACK_IDX, bool BOUNDED>
__global__ void __launch_bounds__(
        max_threads(BOUNDED, bounce_lanes(BOUNDED)))
wave_bounce_kernel(
        Tables p, const int* __restrict__ tile_order, size_t n, int n_bounces,
        float* __restrict__ pay, uint32_t* __restrict__ state,
        int* __restrict__ active, int* __restrict__ wch_out,
        int* __restrict__ idx_out) {
    constexpr int L = bounce_lanes(BOUNDED);
    const bool lead = threadIdx.x % L == 0;  // stores the group's ray
    const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / L;
    const int* order = tile_order + (size_t)blockIdx.x * p.n_chunks;

    Ray r;
    r.state = state[i];
    r.o = {pay[0 * n + i], pay[1 * n + i], pay[2 * n + i]};
    r.d = {pay[3 * n + i], pay[4 * n + i], pay[5 * n + i]};
    r.atten = {pay[6 * n + i], pay[7 * n + i], pay[8 * n + i]};
    r.active = active[i];

    int wch = -1;
    int b = 0;
    for (; b < n_bounces; ++b) {
        // whole-tile skip: sorted dead rays cluster into all-dead tiles,
        // and a tile with no live ray stays so for the remaining bounces
        if (!__syncthreads_or(r.active > 0)) break;
        int tid;
        wch = trace_bounce<TRACK_IDX, L>(p, order, r, tid);
        if (TRACK_IDX && lead) idx_out[b * n + i] = tid;
    }
    if (!lead) return;
    // the planes of the bounces the tile skipped: what the TPU kernel's dead
    // lanes write
    if (TRACK_IDX)
        for (; b < n_bounces; ++b) idx_out[b * n + i] = -1;

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
// launches on ``stream`` and returns cudaGetLastError() as an int
// (cudaErrorInvalidValue, launching nothing, when ``chunk`` is not CHUNK).
// ``idx`` non-null launches the recording instance (K10a, K10b), null the
// render one.

namespace {

template <bool TRACK_IDX, bool BOUNDED>
void launch_first(dim3 grid, int block, cudaStream_t stream,
                  const rt::Tables& p, const int* order,
                  const rt::CameraRow& row, const uint32_t* times, int row0,
                  int height, int width, int height_pad, int width_pad,
                  int tw, int normalize_defocus_dir, float* payf,
                  uint32_t* state, int* active, int* wch, int* idx) {
    rt::wave_first_kernel<TRACK_IDX, BOUNDED><<<grid, block, 0, stream>>>(
        p, order, row, times, row0, height, width, height_pad, width_pad,
        tw, normalize_defocus_dir, payf, state, active, wch, idx);
}

template <bool TRACK_IDX, bool BOUNDED>
void launch_bounce(unsigned grid, int block, cudaStream_t stream,
                   const rt::Tables& p, const int* tile_order, size_t n,
                   int n_bounces, float* pay, uint32_t* state, int* active,
                   int* wch, int* idx) {
    rt::wave_bounce_kernel<TRACK_IDX, BOUNDED><<<grid, block, 0, stream>>>(
        p, tile_order, n, n_bounces, pay, state, active, wch, idx);
}

}  // namespace

extern "C" int rt_wave_first(
        const float* tab, const float* mats, const float* chunks,
        const int* order, const float* cam, const uint32_t* times, int row0,
        float* payf, uint32_t* state, int* active, int* wch, int* idx,
        int n_chunks, int chunk, int n_mats, int height, int width,
        int height_pad, int width_pad, int n_frames, int th, int tw,
        int normalize_defocus_dir, int normalize_reflect_in, int has_metal,
        int has_dielectric, void* stream) {
    if (chunk != rt::CHUNK) return (int)cudaErrorInvalidValue;
    rt::Tables p = {tab, mats, chunks, n_chunks, n_mats,
                    {normalize_reflect_in, has_metal, has_dielectric}};
    rt::CameraRow row;
    for (int c = 0; c < 20; ++c) row.v[c] = cam[c];
    dim3 grid(width_pad / tw, height_pad / th, n_frames);
    const int block = th * tw;
    const bool bounded = block <= rt::TRACE_BLOCK;
    auto launch = idx ? (bounded ? launch_first<true, true>
                                 : launch_first<true, false>)
                      : (bounded ? launch_first<false, true>
                                 : launch_first<false, false>);
    launch(grid, block, (cudaStream_t)stream, p, order, row, times, row0,
           height, width, height_pad, width_pad, tw, normalize_defocus_dir,
           payf, state, active, wch, idx);
    return (int)cudaGetLastError();
}

extern "C" int rt_wave_bounce(
        const float* tab, const float* mats, const float* chunks,
        const int* tile_order, float* pay, uint32_t* state, int* active,
        int* wch, int* idx, long long n, int tile, int n_bounces,
        int n_chunks, int chunk, int n_mats, int normalize_reflect_in,
        int has_metal, int has_dielectric, void* stream) {
    if (chunk != rt::CHUNK) return (int)cudaErrorInvalidValue;
    rt::Tables p = {tab, mats, chunks, n_chunks, n_mats,
                    {normalize_reflect_in, has_metal, has_dielectric}};
    const unsigned grid = (unsigned)(n / tile);
    const bool bounded = tile <= rt::TRACE_BLOCK;
    auto launch = idx ? (bounded ? launch_bounce<true, true>
                                 : launch_bounce<true, false>)
                      : (bounded ? launch_bounce<false, true>
                                 : launch_bounce<false, false>);
    launch(grid, tile * rt::bounce_lanes(bounded), (cudaStream_t)stream, p,
           tile_order, (size_t)n,
           n_bounces, pay, state, active, wch, idx);
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
