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
//                       the flag only adds the index stores.  Their
//                       <false, *, *, true> instances count the scan work
//                       (tris_trace.cuh, point 7); the wrappers launch them
//                       only while the program's spans are on.
//   wave_raygen_kernel  replaces rt/kernels/tris_kernel.py:_wave_raygen_kernel
//                       (primary rays only, for more than one sample per
//                       pixel: every sample's bounces start from them)
//
// The first two call one trace_bounce() (tris_trace.cuh), as both TPU
// kernels call _trace_bounce, so they agree per ray.  The raygen kernel
// calls the same generate_ray() as wave_first_kernel and writes 8 words a
// pixel: bound by bytes (8.4 MB at 512x512, 2.5 us at 3.35 TB/s) and, near
// that, by the issue of its IEEE divisions and square roots.  Its blocks
// are strips of a row, not the tile, so that no thread divides its index
// and a warp stores whole lines.
//
// What the TPU kernel does on (th, tw) planes with selects, this does with
// one thread (the bounce kernel: 1 to 8 threads) per ray; one block is one
// tile.  The tile is the unit of two decisions that change which
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
// bounce).  trace_bounce (tris_trace.cuh) tests group boxes before chunk
// boxes, votes once a batch of 32 boxes and once a candidate chunk, stages
// a candidate's triangles in shared memory and leaves a pair at its first
// failed test.  What is left bounds both kernels: the issue rate of ~80
// instructions a warp-pair and ~30 a box test, and, after a bounce, the
// latency of the heaviest tiles, which the bounce kernel's lane groups cut.
//
// The recorder's bounces (K10b) run on a stream whose live rays the sort
// put first: its glue launches only the tiles that hold them, and from
// bounce 2 on these are a few hundred heavy tiles at 512x512, fewer than
// the card holds at two lanes a ray.  rt_wave_bounce gives such a launch
// the most lanes a ray (8, then 4) at which all its blocks are resident at
// once, and two lanes otherwise, the full card's choice.
//
// Launch bounds: tiles of at most TRACE_BLOCK rays (the default 8x16) take
// the bounded instances, __launch_bounds__(lanes * TRACE_BLOCK); larger
// tiles the ones bounded by 1024 threads and one lane a ray.  No minimum of
// blocks an SM: the kernels compile to 53-60 registers a thread (64 with
// the index stores at two lanes) with no spills, and a minimum that
// forces 40 or 48 registers spills and was slower on an H100 (PERF.md).
//
// Built with -fmad=false: the plain version rounds every multiply and add,
// so the kernel must not contract them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "tris_trace.cuh"

namespace rt {

// lanes a ray of the render bounce kernel (K3) at tiles of at most
// TRACE_BLOCK rays; larger tiles take one lane a ray
constexpr int TRACE_LANES = 2;

// grid (Wp/tw, Hp/th, F), block th*tw.  Outputs are (F*Hp, Wp) planes in
// image order; payf holds 10 of them: o(3) d(3) atten(3) primary_dy.
// TRACK_IDX (the recorder, K10a): idx_out gets the winning row of the
// triangle table, -1 on a miss; unused without it.  COUNT: the scan work is
// added to counts[0..2]; unused without it.
template <bool TRACK_IDX, bool BOUNDED, bool GROUPS, bool COUNT>
__global__ void __launch_bounds__(max_threads(BOUNDED, 1))
wave_first_kernel(
        Tables p, Groups groups, const int* __restrict__ order, CameraRow cam,
        const uint32_t* __restrict__ times, int row0, int height, int width,
        int height_pad, int width_pad, int tw, int normalize_defocus_dir,
        float* __restrict__ payf, uint32_t* __restrict__ state_out,
        int* __restrict__ active_out, int* __restrict__ wch_out,
        int* __restrict__ idx_out, unsigned long long* __restrict__ counts) {
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
    const int wch = trace_bounce<TRACK_IDX, 1, GROUPS, COUNT>(p, groups, order,
                                                              r, tid, counts);

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

// K4's launch: a block is RAYGEN_THREADS consecutive columns of one row of
// one frame, grid (ceil(Wp / RAYGEN_THREADS), Hp, F).  The frame and the row
// come from the block's index, so no thread divides and the frame's time is
// read first, and a warp's store is a whole 128-byte line of a plane.  The
// render tile plays no part: no ray reads another's.  On an H100 two
// pixels a thread with 64-bit stores ran 4-6 % slower at 512x512 (one
// wave: each thread's two rays in turn) and 5 % faster at 1024x1024; four
// pixels 33-35 % slower at 512x512, a flat grid that divides each
// thread's index 6-7 % slower (PERF.md).
constexpr int RAYGEN_THREADS = 128;

// od holds 6 planes of n = F*Hp*Wp: o(3) d(3); pdy_out and state_out one
// each.  A thread's pixel is generate_ray() of its (column, row + row0,
// frame) as in wave_first_kernel; padding pixels are generated too.
__global__ void __launch_bounds__(RAYGEN_THREADS)
wave_raygen_kernel(CameraRow cam, const uint32_t* __restrict__ times,
                   int row0, int height, int width, int height_pad,
                   int width_pad, int normalize_defocus_dir,
                   float* __restrict__ od, float* __restrict__ pdy_out,
                   uint32_t* __restrict__ state_out) {
    const unsigned col = blockIdx.x * RAYGEN_THREADS + threadIdx.x;
    if (col >= (unsigned)width_pad) return;
    const uint32_t time = __ldg(times + blockIdx.z);
    const size_t n = (size_t)gridDim.z * height_pad * width_pad;
    const size_t i =
        ((size_t)blockIdx.z * height_pad + blockIdx.y) * width_pad + col;
    uint32_t state;
    Vec3 o, d;
    generate_ray(cam, col, blockIdx.y + (unsigned)row0, height, width, time,
                 normalize_defocus_dir != 0, state, o, d);
    od[0 * n + i] = o.x;
    od[1 * n + i] = o.y;
    od[2 * n + i] = o.z;
    od[3 * n + i] = d.x;
    od[4 * n + i] = d.y;
    od[5 * n + i] = d.z;
    pdy_out[i] = d.y;
    state_out[i] = state;
}

// Nothing: the fixed cost of a launch of a given grid (chip_smoke.py reads
// it beside K4).
__global__ void empty_kernel() {}

// grid: the first tiles of the stream (all n / tile of them, or those that
// hold its live rays), block tile * L.  pay is (9, n): o(3) d(3) atten(3);
// pay, state and active of the launched tiles are updated in place.
// tile_order is (tiles launched * n_chunks).  TRACK_IDX (the recorder,
// K10b): idx_out is (n_bounces, n) and plane b gets bounce b's winning row
// of the triangle table, -1 on a miss, on a dead ray and in every bounce a
// tile skipped; unused without it.  L lanes a ray: 1 for tiles above
// TRACE_BLOCK rays, else 2, 4 or 8.  COUNT: as wave_first_kernel's.
template <bool TRACK_IDX, int L, bool GROUPS, bool COUNT>
__global__ void __launch_bounds__(max_threads(L > 1, L))
wave_bounce_kernel(
        Tables p, Groups groups, const int* __restrict__ tile_order, size_t n,
        int n_bounces, float* __restrict__ pay, uint32_t* __restrict__ state,
        int* __restrict__ active, int* __restrict__ wch_out,
        int* __restrict__ idx_out, unsigned long long* __restrict__ counts) {
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
        wch = trace_bounce<TRACK_IDX, L, GROUPS, COUNT>(p, groups, order, r,
                                                        tid, counts);
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
// (cudaErrorInvalidValue, launching nothing, when ``chunk`` is not CHUNK or
// an argument is out of range).  ``idx`` non-null launches the recording
// instance (K10a, K10b), null the render one.  ``counts`` non-null (a render
// launch only) launches the render instance that adds its scan work to the
// three int64 counters there.  ``groups``: the table's (n_groups, 6) group
// boxes, or null with n_groups 0.

namespace {

template <bool TRACK_IDX, bool BOUNDED, bool GROUPS, bool COUNT>
void launch_first(dim3 grid, int block, cudaStream_t stream,
                  const rt::Tables& p, const rt::Groups& g, const int* order,
                  const rt::CameraRow& row, const uint32_t* times, int row0,
                  int height, int width, int height_pad, int width_pad,
                  int tw, int normalize_defocus_dir, float* payf,
                  uint32_t* state, int* active, int* wch, int* idx,
                  unsigned long long* counts) {
    rt::wave_first_kernel<TRACK_IDX, BOUNDED, GROUPS, COUNT>
        <<<grid, block, 0, stream>>>(
            p, g, order, row, times, row0, height, width, height_pad,
            width_pad, tw, normalize_defocus_dir, payf, state, active, wch,
            idx, counts);
}

using FirstLaunch = decltype(&launch_first<false, true, false, false>);

// The first kernel's instance for a bound and a table: the recorder's, the
// counting render one or the render one.
template <bool BOUNDED, bool GROUPS>
FirstLaunch first_instance(bool record, bool count) {
    return record  ? launch_first<true, BOUNDED, GROUPS, false>
           : count ? launch_first<false, BOUNDED, GROUPS, true>
                   : launch_first<false, BOUNDED, GROUPS, false>;
}

template <bool TRACK_IDX, int L, bool GROUPS, bool COUNT>
void launch_bounce(unsigned grid, int tile, cudaStream_t stream,
                   const rt::Tables& p, const rt::Groups& g,
                   const int* tile_order, size_t n, int n_bounces, float* pay,
                   uint32_t* state, int* active, int* wch, int* idx,
                   unsigned long long* counts) {
    rt::wave_bounce_kernel<TRACK_IDX, L, GROUPS, COUNT>
        <<<grid, tile * L, 0, stream>>>(p, g, tile_order, n, n_bounces, pay,
                                        state, active, wch, idx, counts);
}

// The render bounce kernel's instance at L lanes, counting or not.
template <int L, bool GROUPS>
decltype(&launch_bounce<false, L, GROUPS, false>) render_bounce(bool count) {
    return count ? launch_bounce<false, L, GROUPS, true>
                 : launch_bounce<false, L, GROUPS, false>;
}

// The blocks of the recorder's bounce kernel at L lanes a ray that the
// current device holds at once (its SMs times the blocks resident on one)
// into *blocks.  Asked of the runtime once for each (device, tile rays,
// grouped) and kept: the record loop launches this kernel four times a
// record from the host.  Returns the error of a failed query.
template <int L>
cudaError_t resident_blocks(int tile, bool grouped, int* blocks) {
    struct Known { int device, tile; bool grouped; int blocks; };
    static std::mutex mu;
    static std::vector<Known> known;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mu);
    for (const Known& k : known) {
        if (k.device == device && k.tile == tile && k.grouped == grouped) {
            *blocks = k.blocks;
            return cudaSuccess;
        }
    }
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm,
        grouped ? rt::wave_bounce_kernel<true, L, true, false>
                : rt::wave_bounce_kernel<true, L, false, false>,
        tile * L, 0);
    if (err != cudaSuccess) return err;
    known.push_back({device, tile, grouped, per_sm * sms});
    *blocks = per_sm * sms;
    return cudaSuccess;
}

}  // namespace

extern "C" int rt_wave_first(
        const float* tab, const float* mats, const float* chunks,
        const float* groups, const int* order, const float* cam,
        const uint32_t* times, int row0, float* payf, uint32_t* state,
        int* active, int* wch, int* idx, int n_chunks, int n_groups,
        int chunk, int n_mats, int height, int width, int height_pad,
        int width_pad, int n_frames, int th, int tw,
        int normalize_defocus_dir, int normalize_reflect_in, int has_metal,
        int has_dielectric, unsigned long long* counts, void* stream) {
    if (chunk != rt::CHUNK || (idx && counts))
        return (int)cudaErrorInvalidValue;
    rt::Tables p = {tab, mats, chunks, n_chunks, n_mats,
                    {normalize_reflect_in, has_metal, has_dielectric}};
    const rt::Groups g = {groups, n_groups};
    rt::CameraRow row;
    for (int c = 0; c < 20; ++c) row.v[c] = cam[c];
    dim3 grid(width_pad / tw, height_pad / th, n_frames);
    const int block = th * tw;
    const bool bounded = block <= rt::TRACE_BLOCK;
    const bool grouped = n_groups > 0;
    const bool record = idx != nullptr, count = counts != nullptr;
    const FirstLaunch launch =
        bounded ? (grouped ? first_instance<true, true>(record, count)
                           : first_instance<true, false>(record, count))
                : (grouped ? first_instance<false, true>(record, count)
                           : first_instance<false, false>(record, count));
    launch(grid, block, (cudaStream_t)stream, p, g, order, row, times, row0,
           height, width, height_pad, width_pad, tw, normalize_defocus_dir,
           payf, state, active, wch, idx, counts);
    return (int)cudaGetLastError();
}

// n: the stream's rays (the planes' stride); n_tiles: the tiles launched,
// the stream's first.
extern "C" int rt_wave_bounce(
        const float* tab, const float* mats, const float* chunks,
        const float* groups, const int* tile_order, float* pay,
        uint32_t* state, int* active, int* wch, int* idx, long long n,
        int n_tiles, int tile, int n_bounces, int n_chunks, int n_groups,
        int chunk, int n_mats, int normalize_reflect_in, int has_metal,
        int has_dielectric, unsigned long long* counts, void* stream) {
    if (chunk != rt::CHUNK || (idx && counts))
        return (int)cudaErrorInvalidValue;
    rt::Tables p = {tab, mats, chunks, n_chunks, n_mats,
                    {normalize_reflect_in, has_metal, has_dielectric}};
    const rt::Groups g = {groups, n_groups};
    const bool bounded = tile <= rt::TRACE_BLOCK;
    const bool grouped = n_groups > 0;
    // the recorder's launch: the most lanes at which all its blocks are
    // resident at once
    int L = !bounded ? 1 : rt::TRACE_LANES;
    if (bounded && idx) {
        int at8 = 0, at4 = 0;
        cudaError_t err = resident_blocks<8>(tile, grouped, &at8);
        if (err == cudaSuccess) err = resident_blocks<4>(tile, grouped, &at4);
        if (err != cudaSuccess) return (int)err;
        L = n_tiles <= at8 ? 8 : n_tiles <= at4 ? 4 : 2;
    }
    // group boxes at 2 lanes in the render kernel and at 4 and 8 in the
    // recorder's: its 2-lane instance spilled registers with them and ran
    // 1-3 % slower on an H100 (PERF.md); tiles above TRACE_BLOCK rays (one
    // lane a ray) test chunk boxes only
    const bool count = counts != nullptr;
    decltype(&launch_bounce<true, 1, false, false>) launch = nullptr;
    switch (L) {
        case 1: launch = idx ? launch_bounce<true, 1, false, false>
                             : render_bounce<1, false>(count); break;
        case 2: launch = idx ? launch_bounce<true, 2, false, false>
                             : grouped ? render_bounce<2, true>(count)
                                       : render_bounce<2, false>(count);
                break;
        case 4: launch = grouped ? launch_bounce<true, 4, true, false>
                                 : launch_bounce<true, 4, false, false>;
                break;
        case 8: launch = grouped ? launch_bounce<true, 8, true, false>
                                 : launch_bounce<true, 8, false, false>;
                break;
        default: return (int)cudaErrorInvalidValue;
    }
    launch((unsigned)n_tiles, tile, (cudaStream_t)stream, p, g, tile_order,
           (size_t)n, n_bounces, pay, state, active, wch, idx, counts);
    return (int)cudaGetLastError();
}

extern "C" int rt_wave_raygen(
        const float* cam, const uint32_t* times, int row0, float* od,
        float* pdy, uint32_t* state, int height, int width, int height_pad,
        int width_pad, int n_frames, int normalize_defocus_dir,
        void* stream) {
    if (height_pad < 1 || height_pad > 65535 || n_frames < 1
            || n_frames > 65535 || width_pad < 1)
        return (int)cudaErrorInvalidValue;
    rt::CameraRow row;
    for (int c = 0; c < 20; ++c) row.v[c] = cam[c];
    const dim3 grid((width_pad + rt::RAYGEN_THREADS - 1)
                        / rt::RAYGEN_THREADS, height_pad, n_frames);
    rt::wave_raygen_kernel<<<grid, rt::RAYGEN_THREADS, 0,
                             (cudaStream_t)stream>>>(
        row, times, row0, height, width, height_pad, width_pad,
        normalize_defocus_dir, od, pdy, state);
    return (int)cudaGetLastError();
}

extern "C" int rt_empty(int blocks, int threads, void* stream) {
    rt::empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
