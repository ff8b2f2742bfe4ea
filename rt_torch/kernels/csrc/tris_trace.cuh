// The chunk-culled closest-hit scan of the triangle and sphere kernels.
// trace_bounce is one bounce of the wavefront kernels (tris_wave.cu: scan,
// material resolve, scatter); cull_scan is the same loop over any primitive,
// which the whole-frame kernels run through packed_scan: triangles in
// tris_mono.cu, spheres in spheres.cu
// (rt/kernels/sphere_kernel.py:_sphere_bounce_chunked).  All triangle
// kernels agree per ray, as the TPU package's kernels share
// rt/kernels/tris_kernel.py:_trace_bounce.
//
// One thread (or LANES threads, point 4) owns a ray and one block is one
// tile.  The tile is the unit of the chunk cull: a chunk of 32 primitives is
// scanned only when some live ray of the TILE enters its box nearer than its
// best hit, chunks are visited in the tile's order, and inside a live chunk
// every live ray of the tile scans all 32 primitives in ascending index with
// strict t < best, also a ray whose own box test failed.  The image depends
// on that union at box-surface roundings, so it is kept: this code computes
// exactly what the plain versions (tris_kernel.trace_bounce,
// sphere_kernel.sphere_bounce_chunked) do, bit for bit.
//
// How both loops do that work on Hopper:
//
// 1. Box tests in batches of BATCH visit entries, one tile vote a batch.
//    A block barrier (__syncthreads_or) for every visit entry would be 1563
//    a ray and bounce on dragon, where 0.5 % (bounce 0) to 8 % (bounce 1)
//    of the tile-chunk visits can be live at all.  Instead the block
//    stages a batch's chunk ids and boxes in shared memory (the next
//    batch's loads overlap this one's tests), each thread tests its ray
//    against them with no barrier between, and keeps a bit mask of the
//    part of the live test that does not depend on the best t: alive &&
//    tmin <= tmax && tmax >= 0.  The tile ORs the masks (__reduce_or_sync,
//    one word a warp, one barrier).  Only the set bits, in ascending order,
//    then take the exact vote __syncthreads_or(bit && tmin < bt) with the
//    current bt.  A chunk whose bit is clear in the whole tile would have
//    failed that vote, and a skipped chunk has no side effect, so the split
//    changes nothing.  The min/max of the slab test are fminf/fmaxf, one
//    instruction each (the plain version's selects cost three): they
//    differ from those only in the sign of a zero result, and tmin/tmax
//    feed only comparisons, where -0 == +0, so the mask and the vote are
//    the same bits (tests/test_torch_cull.py).
// 2. A candidate's 32 primitives staged in shared memory (triangles: rows
//    padded to 20 floats, so the lanes of one ray read distinct banks;
//    spheres: centre and radius, one 16-byte row): the scan reads a
//    primitive as 128-bit shared loads.  The copy is issued before the
//    vote, so the vote's barrier publishes it; two buffers alternate, so
//    the next copy never overwrites rows a slow warp still reads.
// 3. A scan with a compile-time trip count that leaves a pair at its first
//    failed test (triangles: det, then u, then v; spheres: the
//    discriminant, then the sign of the near root's numerator); the warp
//    leaves when all its lanes do.  A rejected pair's values are never
//    used, so no result changes; the reciprocal, root and divide stay IEEE.
//    The sphere scan runs in two phases: every discriminant's sign of the
//    lane's share first (independent work a warp issues back to back),
//    then the pairs that pass, in ascending order.  The winner's row is
//    read once the chunk is scanned.
// 4. LANES lanes a ray: each tests a share of the boxes and scans a share
//    of the primitives, merged by shuffles (see trace_bounce, cull_scan;
//    cull_scan's lanes take interleaved boxes, so a short batch, cover's
//    16 entries, stays balanced).  After a bounce the work of a tile is
//    uneven (dragon at 512x512: 49 chunk scans a live tile on average, 390
//    in the heaviest), and a launch ends with the heaviest tiles' dependent
//    chains.  The wave kernels take 1, 2, 4 or 8 lanes; the recorder's
//    bounce kernel runs only the tiles that hold live rays and takes the
//    most lanes at which all of them run at once (tris_wave.cu).
// 6. Group boxes (trace_bounce, tables of at least 4 groups).  Each run of
//    GROUP consecutive table chunks has a box, the exact min/max of its
//    chunks' boxes (tris_kernel.group_boxes); the table is Morton-clustered,
//    so these are compact.  A ray tests the first MAX_GROUPS group boxes
//    once a bounce and runs the slab test of a batch entry only where the
//    entry's group was entered: a chunk's slab lies within its group's
//    (RN(b - o) * id is monotone in b for a fixed ray), so a missed group
//    clears no mask bit the chunk test would set.  An axis whose products
//    hold a NaN (o on the plane of a face, a direction component of +-0) is
//    widened to everything in the group test, since fminf/fmaxf drop the
//    NaN (tests/test_torch_record_cull.py).  Entries of later groups take
//    the chunk test as before.  At one lane a ray (the first kernel: 32
//    entries a lane a batch) warp 0 writes each group's 32-bit word of the
//    batch's entries and a ray tests only the entries of the words of its
//    groups; at 2-8 lanes (4-16 entries a lane) the lane checks each
//    entry's group bit.  On an H100 each form was the faster at its lanes
//    (PERF.md).
// 7. Counting (trace_bounce<..., COUNT = true>, the render wave kernels'
//    counting instances): each lane sums its share of the bounce's box
//    tests and, once a ray, the ray and its chunk scans, as the plain
//    version's scan_counts entries 0 and 1 define them; a warp adds its
//    sums to the launch's accumulator with one atomic each.  The other
//    instances compile as before.
//
// The whole-frame kernels trace pixel tiles for the whole frame, so their
// dead rays stay where they are: from bounce 2 on most of their warps are
// nearly empty.  packed_scan (point 5) gives them the live rays packed.
//
// 5. Live-ray packing.  At the top of a bounce the block numbers its live
//    rays in thread order (a ballot a warp, a prefix over the warps in
//    shared memory) and ships each one's o and d to slot `rank` in dynamic
//    shared memory; thread group k (LANES threads) then scans the ray of
//    slot k, so only ceil(n_live * LANES / 32) warps run scans and the others
//    only cast their (false) votes and pass the barriers.  The scan writes
//    (best t, winning row) back to the slot, and the home thread resolves
//    and scatters its own ray: the RNG state, attenuation and pixel never
//    move.  When a tile has few live rays, the idle threads become lanes:
//    a ray gets the most lanes (up to PACK_MAX_LANES) that its live count
//    leaves threads for.  A ray's scan is unchanged wherever it runs (the
//    same chunks, order and starting best t), and the tile's union covers
//    the same live rays, so the packing changes no bit.
//
// The constants were timed on an H100 against the alternatives (PERF.md):
// unroll 4 for triangles (1 and 2 slower, 8 the same), 2 lanes a ray in the
// bounce kernel on a full card (4 lose to occupancy; the first kernel keeps
// 1),
// fminf/fmaxf over the selects, no register bound (tris_wave.cu); for the
// whole-frame kernels packing, one thread a ray, up to PACK_MAX_LANES lanes
// where a tile's live count leaves the threads, and the two-phase sphere
// scan (two lanes a ray, no packing and a one-phase scan were slower).
//
// Bound: operations (46 a ray-triangle pair, 23 a ray-sphere pair, 24 a box
// test, the plain versions' counts).  What limits the kernels now is the
// issue rate of the wavefront kernels: ~80 instructions a warp-pair on a
// triangle's full path (-fmad=false, the IEEE reciprocal's range check, the
// early exits' branches), ~30 a box test; on dragon the heaviest tiles'
// latency.  The whole-frame kernels are bound by latency: a packed tile
// keeps few warps busy, whose dependent chains the SM cannot hide (more
// lanes a ray past 4, or more registers and fewer blocks, were slower).
// PERF.md has the numbers.
#pragma once

#include "rt_device.cuh"

namespace rt {

constexpr float EPSILON_TRIS = 1e-4f;
constexpr int TRI_COLS = 13;  // a(3) e1(3) e2(3) normal(3) mat_id
constexpr int SPH_COLS = 8;   // centre(3) radius albedo(3) material parameter
constexpr int CHUNK = 32;     // primitives a chunk (tris_kernel.CHUNK)
constexpr int BATCH = 32;     // visit entries a box batch: a mask bit each
// floats a staged triangle (13 used): 16-byte aligned rows whose first 16
// bytes fall on distinct banks for 4 consecutive rows, which the lanes of
// one ray read together
constexpr int TRI_ROW = 20;
constexpr int MAX_WARPS = 32;
constexpr int GROUP = 32;       // chunks a group box (tris_kernel.GROUP)
constexpr int MAX_GROUPS = 64;  // group boxes a ray tests: its mask's bits
// the most lanes a packed ray of the whole-frame kernels gets
constexpr int PACK_MAX_LANES = 4;
// Tiles of at most TRACE_BLOCK rays (the default 8x16) take the BOUNDED
// kernel instances, __launch_bounds__(lanes * TRACE_BLOCK); larger tiles the
// ones bounded by 1024 threads and one lane a ray.
constexpr int TRACE_BLOCK = 128;

__host__ __device__ constexpr int max_threads(bool bounded, int lanes) {
    return bounded ? lanes * TRACE_BLOCK : 1024;
}

struct Tables {
    const float* tab;     // (m_pad, 13), 16-byte aligned
    const float* mats;    // (n_mats, 5): albedo rgb, param, kind
    const float* chunks;  // (n_chunks, 6): box min xyz, max xyz
    int n_chunks;
    int n_mats;
    ScatterFlags flags;
};

// The group boxes of a wave kernel's table: (n, 6) f32, min xyz, max xyz
// of GROUP consecutive chunks; n = 0 (boxes null) tests chunks only.
struct Groups {
    const float* boxes;
    int n;
};

// The cull loops' staging area (triangles 6.6 KB, spheres 1.8 KB).  Boxes,
// chunk ids and mask words are double-buffered by batch: batch b+1 is
// staged while batch b is tested.
template <int ROW4>
struct CullShared {
    float4 rows[2][CHUNK * ROW4];  // two candidates' primitives
    float4 box[2][BATCH][2];       // min xyz, max x | max yz, -, -
    int ci[2][BATCH];              // the batch's chunk ids
    unsigned warp_mask[2][MAX_WARPS];  // each warp's OR of its masks
};

// One staging area a row width, shared by the instances of every lane count
// a kernel runs.
template <int ROW4>
__device__ __forceinline__ CullShared<ROW4>& cull_shared() {
    __shared__ CullShared<ROW4> sh;
    return sh;
}

// The slab test of the plain version, on a staged box.
__device__ __forceinline__ void slab(const float4* box, Vec3 o, Vec3 id,
                                     float& tmin, float& tmax) {
    const float4 lo = box[0], hi = box[1];
    float t0x = (lo.x - o.x) * id.x;
    float t1x = (lo.w - o.x) * id.x;
    float t0y = (lo.y - o.y) * id.y;
    float t1y = (hi.x - o.y) * id.y;
    float t0z = (lo.z - o.z) * id.z;
    float t1z = (hi.y - o.z) * id.z;
    tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
}

// Stage the chunk ids and boxes of visit entries [base, base + BATCH) (one
// coalesced pass; the entries past n_chunks are left alone).
__device__ __forceinline__ void stage_boxes(const float* __restrict__ chunks,
                                            const int* __restrict__ order,
                                            int n_chunks, int base,
                                            float4 (*box)[2], int* ci_out) {
    const int nb = min(BATCH, n_chunks - base);
    for (int k = threadIdx.x; k < nb * 6; k += blockDim.x) {
        const int j = k / 6, c = k - 6 * j;
        const int ci = __ldg(order + base + j);
        reinterpret_cast<float*>(box[j])[c] = __ldg(chunks + ci * 6 + c);
        if (c == 0) ci_out[j] = ci;
    }
}

// One axis of a group's slab test, widened to everything where a product
// is NaN ((face - o) * +-inf for o on the face's plane; t0 + t1 is NaN then,
// and also for the interval (-inf, +inf), which is everything already).
__device__ __forceinline__ void wide_axis(float lo, float hi, float o,
                                          float id, float& a, float& b) {
    const float t0 = (lo - o) * id, t1 = (hi - o) * id;
    const bool nan = isnan(t0 + t1);
    a = nan ? -INFINITY : fminf(t0, t1);
    b = nan ? INFINITY : fmaxf(t0, t1);
}

// Whether the ray may enter one of the chunk boxes inside group box `box`
// (point 6): false only where every one of them has its mask bit clear.
__device__ __forceinline__ bool group_entered(const float4* box, Vec3 o,
                                              Vec3 id) {
    const float4 lo = box[0], hi = box[1];
    float ax, bx, ay, by, az, bz;
    wide_axis(lo.x, lo.w, o.x, id.x, ax, bx);
    wide_axis(lo.y, hi.x, o.y, id.y, ay, by);
    wide_axis(lo.z, hi.y, o.z, id.z, az, bz);
    const float tmin = fmaxf(fmaxf(ax, ay), az);
    const float tmax = fminf(fminf(bx, by), bz);
    return (tmin <= tmax) && (tmax >= 0.0f);
}

// trace_bounce's group staging: the first MAX_GROUPS group boxes, staged
// once a call, and by batch slot (as CullShared's boxes) the entries of the
// batch in each group: bit j of member[slot][g] is set where visit entry
// base + j lies in group g (g = MAX_GROUPS: in any later group).
struct GroupShared {
    float4 box[MAX_GROUPS][2];
    unsigned member[2][MAX_GROUPS + 1];
};

__device__ __forceinline__ GroupShared& group_shared() {
    __shared__ GroupShared sh;
    return sh;
}

// Warp 0 writes the member words of visit entries [base, base + BATCH): a
// ballot for each group present (one coalesced pass over the entries).
__device__ __forceinline__ void stage_members(const int* __restrict__ order,
                                              int n_chunks, int base,
                                              unsigned* member) {
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    for (int g = lane; g <= MAX_GROUPS; g += 32) member[g] = 0u;
    __syncwarp();
    const bool in = base + lane < n_chunks;
    const unsigned g =
        in ? min((unsigned)__ldg(order + base + lane) / GROUP,
                 (unsigned)MAX_GROUPS)
           : 0u;
    unsigned todo = __ballot_sync(0xffffffffu, in);
    while (todo) {
        const unsigned lead = __shfl_sync(0xffffffffu, g, __ffs(todo) - 1);
        const unsigned m = __ballot_sync(0xffffffffu, in && g == lead);
        if (lane == 0) member[lead] = m;
        todo &= ~m;
    }
}

// A warp's sums of a bounce's scan work added to a counting launch's
// accumulator (slots: live rays, ray-chunk scans, box tests).  Every lane
// of the warp calls it.
__device__ __forceinline__ void add_scan_counts(unsigned long long* counts,
                                                unsigned rays, unsigned scans,
                                                unsigned boxes) {
    rays = __reduce_add_sync(0xffffffffu, rays);
    scans = __reduce_add_sync(0xffffffffu, scans);
    boxes = __reduce_add_sync(0xffffffffu, boxes);
    if ((threadIdx.x & 31) == 0) {
        atomicAdd(counts + 0, (unsigned long long)rays);
        atomicAdd(counts + 1, (unsigned long long)scans);
        atomicAdd(counts + 2, (unsigned long long)boxes);
    }
}

// ---- the wavefront kernels' bounce -----------------------------------------
// The wave kernels keep a loop of their own: on the cull_scan template
// below they ran 0-4 % slower on an H100 (PERF.md), so only the whole-frame
// kernels take the template.  It shares the staging area and stage_boxes.

// Copy chunk ci's 32 x 13 floats into 16-float rows: 128-bit coalesced
// loads (a chunk is 104 float4s and starts 16-byte aligned).
__device__ __forceinline__ void stage_chunk(const float* __restrict__ tab,
                                            int ci, float* dst) {
    const float4* src = reinterpret_cast<const float4*>(
        tab + (size_t)ci * CHUNK * TRI_COLS);
    for (int k = threadIdx.x; k < CHUNK * TRI_COLS / 4; k += blockDim.x) {
        const float4 v = __ldg(src + k);
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int e = 4 * k + c;
            const int row = e / TRI_COLS;
            dst[row * TRI_ROW + (e - row * TRI_COLS)] = w[c];
        }
    }
}

// One bounce for this thread's ray.  EVERY thread of the block must call it
// (block-wide votes inside), with blockDim.x a multiple of 32.  order: this
// tile's n_chunks visit entries.  Returns the winning chunk id, -1 on a
// miss or a dead ray.  TRACK_IDX (the recorder only): tid gets the winning
// row of the triangle table, -1 on a miss or a dead ray; without it tid is
// left alone.
//
// LANES > 1: the LANES consecutive lanes of a warp from a multiple of LANES
// hold the same ray (the caller gives them the same state, and all return
// the same result).  Lane g of the group tests groups g, g + LANES, ... and
// the g-th share of a batch's boxes, and scans triangles g, g + LANES, ...
// of a live chunk, from the ray's best t at the chunk's start; shuffles
// then take the least (t, index) of the shares.  That is the sequential
// scan's result: its winner is the first triangle, in index order, of
// least t below the best t before the chunk.  LANES warps share a tile's
// pairs where one ran them: a tile with much work (dragon, after a bounce)
// runs its dependent chains in 1/LANES of the time.
//
// COUNT (point 7): the bounce's live rays, chunk scans and box tests are
// added to counts[0..2]; counts is unused without it.
template <bool TRACK_IDX, int LANES = 1, bool GROUPS = false,
          bool COUNT = false>
__device__ int trace_bounce(const Tables& p, const Groups& groups,
                            const int* __restrict__ order, Ray& r, int& tid,
                            unsigned long long* counts = nullptr) {
    static_assert(LANES == 1 || LANES == 2 || LANES == 4 || LANES == 8,
                  "1, 2, 4 or 8 lanes a ray");
    constexpr int BOXES = BATCH / LANES;  // box tests a lane a batch
    constexpr int TRIS = CHUNK / LANES;   // pairs a lane a live chunk
    // one lane a ray tests the entries of its entered groups from the
    // batch's member words; a lane of several checks the group of each
    // entry of its share
    constexpr bool MEMBERS = GROUPS && LANES == 1;
    CullShared<TRI_ROW / 4>& sh = cull_shared<TRI_ROW / 4>();
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    const int half = (int)(threadIdx.x % LANES);  // this lane's share
    const bool alive = r.active > 0;
    const Vec3 o = r.o, d = r.d;
    const Vec3 id = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};

    float bt = FLT_MAX_WGSL;
    Vec3 bn = {0.0f, 0.0f, 0.0f};
    float bmid = 0.0f;
    int wch = -1, wtid = -1;
    int buf = 0;  // staging buffer of the next candidate
    // COUNT: this lane's box tests; the ray's chunk scans (its first lane)
    unsigned n_boxes = 0u, n_scans = 0u;

    // batch b's boxes, ids, member and mask words are in slot b & 1.  Every
    // read of a slot precedes a barrier that every thread passes before the
    // slot is written again (two batches on), also across calls.  The group
    // boxes are read before the first batch's barrier of the call
    GroupShared* gsh = nullptr;  // only the instances with group boxes
    const int n_groups = GROUPS ? min(groups.n, MAX_GROUPS) : 0;
    if constexpr (GROUPS) {
        gsh = &group_shared();
        for (int k = threadIdx.x; k < n_groups * 6; k += blockDim.x)
            reinterpret_cast<float*>(gsh->box[k / 6])[k % 6] =
                __ldg(groups.boxes + k);
        if (MEMBERS) stage_members(order, p.n_chunks, 0, gsh->member[0]);
    }
    stage_boxes(p.chunks, order, p.n_chunks, 0, sh.box[0], sh.ci[0]);
    __syncthreads();

    // bit g: the ray may enter group g
    unsigned long long entered = 0ull;
    if constexpr (GROUPS) {
        if (alive)
            for (int g = half; g < n_groups; g += LANES) {
                if (COUNT) ++n_boxes;
                if (group_entered(gsh->box[g], o, id)) entered |= 1ull << g;
            }
#pragma unroll
        for (int step = 1; step < LANES; step *= 2)
            entered |= __shfl_xor_sync(0xffffffffu, entered, step);
    }

    for (int base = 0, slot = 0; base < p.n_chunks;
         base += BATCH, slot ^= 1) {
        const int nb = min(BATCH, p.n_chunks - base);
        // the next batch's loads overlap this one's tests
        if (base + BATCH < p.n_chunks) {
            stage_boxes(p.chunks, order, p.n_chunks, base + BATCH,
                        sh.box[slot ^ 1], sh.ci[slot ^ 1]);
            if constexpr (MEMBERS)
                stage_members(order, p.n_chunks, base + BATCH,
                              gsh->member[slot ^ 1]);
        }

        // this ray's bits (this lane's share of the batch): the live test
        // without its bt term
        float4 (*box)[2] = sh.box[slot];
        unsigned mask = 0u;
        if constexpr (MEMBERS) {
            // the entries of the groups entered and of later groups
            const unsigned* member = gsh->member[slot];
            unsigned test = alive ? member[MAX_GROUPS] : 0u;
            for (unsigned long long e = entered; e; e &= e - 1ull)
                test |= member[__ffsll((long long)e) - 1];
            if (COUNT) n_boxes += __popc(test);
            while (test) {
                const int j = __ffs(test) - 1;
                test &= test - 1u;
                float tmin, tmax;
                slab(box[j], o, id, tmin, tmax);
                if ((tmin <= tmax) && (tmax >= 0.0f)) mask |= 1u << j;
            }
        } else if (alive) {
#pragma unroll
            for (int m = 0; m < BOXES; ++m) {
                const int j = half * BOXES + m;
                if (j < nb) {
                    if (GROUPS) {
                        const unsigned g = (unsigned)sh.ci[slot][j] / GROUP;
                        if (g < MAX_GROUPS && !((entered >> g) & 1ull))
                            continue;
                    }
                    if (COUNT && GROUPS) ++n_boxes;
                    float tmin, tmax;
                    slab(box[j], o, id, tmin, tmax);
                    if ((tmin <= tmax) && (tmax >= 0.0f)) mask |= 1u << j;
                }
            }
        }
        const unsigned wmask = __reduce_or_sync(0xffffffffu, mask);
        if ((threadIdx.x & 31) == 0) sh.warp_mask[slot][warp] = wmask;
        // publishes the mask words, and the next batch's staging
        __syncthreads();
        unsigned cand = 0u;
        for (int w = 0; w < n_warps; ++w) cand |= sh.warp_mask[slot][w];

        // the candidates in visit order, each with the exact vote (cast by
        // the lane that tested the box)
        while (cand) {
            const int j = __ffs(cand) - 1;
            cand &= cand - 1u;
            const int ci = sh.ci[slot][j];
            float* tri = reinterpret_cast<float*>(sh.rows[buf]);
            buf ^= 1;
            stage_chunk(p.tab, ci, tri);
            bool live = false;
            if ((mask >> j) & 1u) {
                float tmin, tmax;
                slab(box[j], o, id, tmin, tmax);
                live = tmin < bt;
            }
            // the barrier also publishes the staged rows
            const bool scan = __syncthreads_or(live) && alive;
            // the lanes that scan, all of each ray's group (converged here)
            const unsigned lanes =
                LANES > 1 ? __ballot_sync(0xffffffffu, scan) : 0u;
            if (!scan) continue;
            if (COUNT && half == 0) ++n_scans;

            const float prev = bt;
            int kbest = CHUNK;
            const float4* t4 = reinterpret_cast<const float4*>(tri);
#pragma unroll 4
            for (int m = 0; m < TRIS; ++m) {
                const int k = m * LANES + half;
                const float4* row4 = t4 + k * (TRI_ROW / 4);
                // row: a.xyz e1.x | e1.yz e2.xy | e2.z n.xyz | mat_id
                const float4 r0 = row4[0], r1 = row4[1], r2 = row4[2];
                const Vec3 e1 = {r0.w, r1.x, r1.y};
                const Vec3 e2 = {r1.z, r1.w, r2.x};
                const Vec3 h = cross3(d, e2);
                const float det = dot3(e1, h);
                if (!(fabsf(det) >= EPSILON_TRIS)) continue;
                const float inv_det = 1.0f / det;
                const Vec3 s = sub3(o, Vec3{r0.x, r0.y, r0.z});
                const float u = inv_det * dot3(s, h);
                if (!((u >= 0.0f) && (u <= 1.0f))) continue;
                const Vec3 q = cross3(s, e1);
                const float v = inv_det * dot3(d, q);
                if (!((v >= 0.0f) && (u + v <= 1.0f))) continue;
                const float t = inv_det * dot3(e2, q);
                if ((t >= EPSILON_TRIS) && (t < bt)) {
                    bt = t;
                    kbest = k;
                }
            }
            // the shares' least (t, index), pairwise
#pragma unroll
            for (int step = 1; step < LANES; step *= 2) {
                const float bt_other = __shfl_xor_sync(lanes, bt, step);
                const int k_other = __shfl_xor_sync(lanes, kbest, step);
                if (bt_other < bt || (bt_other == bt && k_other < kbest)) {
                    bt = bt_other;
                    kbest = k_other;
                }
            }
            // the chunk whose scan last improved best-t owns the hit; the
            // normal and material are the last improving triangle's
            if (bt < prev) {
                wch = ci;
                const float* row = tri + kbest * TRI_ROW;
                bn = {row[9], row[10], row[11]};
                bmid = row[12];
                wtid = ci * CHUNK + kbest;
            }
        }
    }

    if constexpr (COUNT) {
        // without group boxes: every chunk box for each ray of the tile,
        // dead ones too (the plain version's definition; a tile with no
        // live ray never gets here)
        if (!GROUPS) n_boxes = half == 0 ? (unsigned)p.n_chunks : 0u;
        add_scan_counts(counts, alive && half == 0, n_scans, n_boxes);
    }
    if (TRACK_IDX) tid = wtid;
    const bool hit = alive && (bt != FLT_MAX_WGSL);
    r.active = hit ? 1 : 0;
    if (!hit) {
        if (TRACK_IDX) tid = -1;
        return -1;
    }

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


// ---- the primitives of cull_scan -------------------------------------------
// A primitive type gives the cull loop its ray, its staged row (ROW4
// float4s), the copy of a chunk into the staging area and the scan of a
// lane's share of a staged chunk.

struct Tri {
    static constexpr int ROW4 = TRI_ROW / 4;
    struct Ray {
        Vec3 o, d;
    };
    __device__ static Ray ray(Vec3 o, Vec3 d) { return {o, d}; }

    __device__ static void stage(const float* __restrict__ tab, int ci,
                                 float4* rows) {
        stage_chunk(tab, ci, reinterpret_cast<float*>(rows));
    }

    // Triangles half, half + LANES, ... of a staged chunk, Moeller-Trumbore
    // with strict t < bt, unrolled by 4.
    template <int LANES>
    __device__ static void scan(const float4* t4, int half, const Ray& r,
                                float& bt, int& kbest) {
        const Vec3 o = r.o, d = r.d;
#pragma unroll 4
        for (int m = 0; m < CHUNK / LANES; ++m) {
            const int k = m * LANES + half;
            const float4* row4 = t4 + k * ROW4;
            // row: a.xyz e1.x | e1.yz e2.xy | e2.z n.xyz | mat_id
            const float4 r0 = row4[0], r1 = row4[1], r2 = row4[2];
            const Vec3 e1 = {r0.w, r1.x, r1.y};
            const Vec3 e2 = {r1.z, r1.w, r2.x};
            const Vec3 h = cross3(d, e2);
            const float det = dot3(e1, h);
            if (!(fabsf(det) >= EPSILON_TRIS)) continue;
            const float inv_det = 1.0f / det;
            const Vec3 s = sub3(o, Vec3{r0.x, r0.y, r0.z});
            const float u = inv_det * dot3(s, h);
            if (!((u >= 0.0f) && (u <= 1.0f))) continue;
            const Vec3 q = cross3(s, e1);
            const float v = inv_det * dot3(d, q);
            if (!((v >= 0.0f) && (u + v <= 1.0f))) continue;
            const float t = inv_det * dot3(e2, q);
            if ((t >= EPSILON_TRIS) && (t < bt)) {
                bt = t;
                kbest = k;
            }
        }
    }

};

// The ray's quadratic, hoisted: d is fixed within a bounce and the
// multiples of a are exact exponent shifts.
struct Quadratic {
    Vec3 o, d;
    float two_a, four_a;
};

// One (ray, sphere) pair of a row (centre.xyz, radius): true, with its t,
// when the near root is a hit nearer than bt (strict 0 < t < bt).
//
// The plain version computes t = (-b - sqrt(max(disc, 0))) / 2a, sets it to
// -1 where disc < 0, and keeps 0 < t < bt.  Two exact early exits: where
// !(disc >= 0) that t is -1 or NaN (a NaN disc), rejected without the root;
// where !(num > 0), num = -b - sqrt(disc), the quotient by 2a = 2|d|^2 (>= 0
// or NaN) is <= 0, a signed zero or NaN, rejected without the divide.  A
// pair that reaches them takes the IEEE sqrtf and divide.  Padding rows
// (radius -1e30: r*r = +inf) give disc = +inf and num = -inf, or a NaN disc
// for a zero direction: rejected either way.
__device__ __forceinline__ float sphere_disc(float4 s, const Quadratic& q,
                                             float& b) {
    const Vec3 oc = sub3(q.o, {s.x, s.y, s.z});
    b = 2.0f * dot3(oc, q.d);
    const float cc = dot3(oc, oc) - s.w * s.w;
    return b * b - q.four_a * cc;
}

__device__ __forceinline__ bool hit_sphere(float4 s, const Quadratic& q,
                                           float bt, float& t) {
    float b;
    const float disc = sphere_disc(s, q, b);
    if (!(disc >= 0.0f)) return false;
    const float num = -b - sqrtf(disc);
    if (!(num > 0.0f)) return false;
    t = num / q.two_a;
    return t > 0.0f && t < bt;
}

struct Sph {
    static constexpr int ROW4 = 1;  // centre and radius: the scan's words
    using Ray = Quadratic;
    __device__ static Ray ray(Vec3 o, Vec3 d) {
        const float a = dot3(d, d);
        return {o, d, 2.0f * a, 4.0f * a};
    }

    // The first 16 bytes of chunk ci's 32 rows of SPH_COLS floats (a row is
    // 32 bytes, 16-byte aligned): one 128-bit load each.
    __device__ static void stage(const float* __restrict__ tab, int ci,
                                 float4* rows) {
        for (int k = threadIdx.x; k < CHUNK; k += blockDim.x)
            rows[k] = __ldg(reinterpret_cast<const float4*>(
                tab + (size_t)(ci * CHUNK + k) * SPH_COLS));
    }

    // Spheres half, half + LANES, ... of a staged chunk.  In two phases:
    // the discriminants' signs first, independent of each other and of bt
    // (a warp runs them back to back, where the branch of each pair's
    // early exit serialised them), then the pairs that pass, in ascending
    // order.  The same pairs reach the same comparisons as in one phase.
    template <int LANES>
    __device__ static void scan(const float4* rows, int half, const Ray& q,
                                float& bt, int& kbest) {
        unsigned pass = 0u;
#pragma unroll
        for (int m = 0; m < CHUNK / LANES; ++m) {
            float b;
            if (sphere_disc(rows[m * LANES + half], q, b) >= 0.0f)
                pass |= 1u << m;
        }
        while (pass) {
            const int k = (__ffs(pass) - 1) * LANES + half;
            pass &= pass - 1u;
            float t;
            if (hit_sphere(rows[k], q, bt, t)) {
                bt = t;
                kbest = k;
            }
        }
    }
};

// ---- the cull loop ---------------------------------------------------------

// The closest hit of this thread's ray over the visit entries `order` (this
// tile's n_chunks chunk ids) of P's table: best and win (from FLT_MAX_WGSL
// and -1) get the best t and its row of the table.  EVERY thread of the
// block must call it (block-wide votes inside), with blockDim.x a multiple
// of 32; a thread whose ray is not `alive` only votes.  id: the inverse
// direction, for the box tests.
//
// LANES > 1: the LANES consecutive lanes of a warp from a multiple of LANES
// hold the same ray (the caller gives them the same ray, and all return
// the same result).  Lane g of the group tests boxes g, g + LANES, ... of a
// batch (a short batch, such as cover's 16 entries, stays balanced) and
// scans primitives g, g + LANES, ... of a live chunk, from the ray's best t
// at the chunk's start; shuffles then take the least (t, index) of the
// shares.  That is the sequential scan's result: its winner
// is the first primitive, in index order, of least t below the best t
// before the chunk.  LANES warps share a tile's pairs where one ran them: a
// tile with much work runs its dependent chains in 1/LANES of the time.
template <class P, int LANES>
__device__ __forceinline__ void cull_scan(const float* __restrict__ tab,
                                          const float* __restrict__ chunks,
                                          int n_chunks,
                                          const int* __restrict__ order,
                                          bool alive, Vec3 id,
                                          const typename P::Ray& ray,
                                          float& best, int& win) {
    static_assert(LANES >= 1 && LANES <= 32 && (LANES & (LANES - 1)) == 0,
                  "a power of two of lanes a ray, at most a warp");
    constexpr int BOXES = BATCH / LANES;  // box tests a lane a batch
    CullShared<P::ROW4>& sh = cull_shared<P::ROW4>();
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    const int half = (int)(threadIdx.x % LANES);  // this lane's share
    int buf = 0;  // staging buffer of the next candidate

    // batch b's boxes, ids and mask words are in slot b & 1.  Every read of
    // a slot precedes a barrier that every thread passes before the slot is
    // written again (two batches on), also across calls
    stage_boxes(chunks, order, n_chunks, 0, sh.box[0], sh.ci[0]);
    __syncthreads();
    for (int base = 0, slot = 0; base < n_chunks; base += BATCH, slot ^= 1) {
        const int nb = min(BATCH, n_chunks - base);
        // the next batch's loads overlap this one's tests
        if (base + BATCH < n_chunks)
            stage_boxes(chunks, order, n_chunks, base + BATCH,
                        sh.box[slot ^ 1], sh.ci[slot ^ 1]);

        // this ray's bits (this lane's share of the batch): the live test
        // without its bt term
        float4 (*box)[2] = sh.box[slot];
        unsigned mask = 0u;
        if (alive) {
#pragma unroll
            for (int m = 0; m < BOXES; ++m) {
                const int j = m * LANES + half;
                if (j < nb) {
                    float tmin, tmax;
                    slab(box[j], ray.o, id, tmin, tmax);
                    if ((tmin <= tmax) && (tmax >= 0.0f)) mask |= 1u << j;
                }
            }
        }
        const unsigned wmask = __reduce_or_sync(0xffffffffu, mask);
        if ((threadIdx.x & 31) == 0) sh.warp_mask[slot][warp] = wmask;
        // publishes the mask words, and the next batch's staging
        __syncthreads();
        unsigned cand = 0u;
        for (int w = 0; w < n_warps; ++w) cand |= sh.warp_mask[slot][w];

        // the candidates in visit order, each with the exact vote (cast by
        // the lane that tested the box)
        while (cand) {
            const int j = __ffs(cand) - 1;
            cand &= cand - 1u;
            const int ci = sh.ci[slot][j];
            const float4* rows = sh.rows[buf];
            P::stage(tab, ci, sh.rows[buf]);
            buf ^= 1;
            bool live = false;
            if ((mask >> j) & 1u) {
                float tmin, tmax;
                slab(box[j], ray.o, id, tmin, tmax);
                live = tmin < best;
            }
            // the barrier also publishes the staged rows
            const bool scan = __syncthreads_or(live) && alive;
            // the lanes that scan, all of each ray's group (converged here)
            const unsigned lanes =
                LANES > 1 ? __ballot_sync(0xffffffffu, scan) : 0u;
            if (!scan) continue;

            const float prev = best;
            float bt = prev;
            int kbest = CHUNK;
            P::template scan<LANES>(rows, half, ray, bt, kbest);
            // the shares' least (t, index), pairwise
#pragma unroll
            for (int step = 1; step < LANES; step *= 2) {
                const float bt_other = __shfl_xor_sync(lanes, bt, step);
                const int k_other = __shfl_xor_sync(lanes, kbest, step);
                if (bt_other < bt || (bt_other == bt && k_other < kbest)) {
                    bt = bt_other;
                    kbest = k_other;
                }
            }
            // the chunk whose scan last improved best-t owns the hit
            best = bt;
            if (bt < prev) win = ci * CHUNK + kbest;
        }
    }
}

// ---- the whole-frame kernels' triangle resolve -----------------------------

// Material of the winning mat id, hit record, scatter and carry update of a
// ray that hit at bt (what the plain version does on its hit mask, and
// trace_bounce's tail).
__device__ __forceinline__ void scatter_tri(const Tables& p, Ray& r,
                                            float bt, Vec3 bn, float bmid) {
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
    const Vec3 o = r.o, d = r.d;
    Vec3 point = add3(o, scale3(d, bt));
    bool front_face = dot3(bn, d) > 0.0f;
    Vec3 nd = d;
    scatter(r.state, nd, bn, front_face, param, (int)kind_f, p.flags);
    r.o = point;
    r.d = nd;
    r.atten = {r.atten.x * albedo.x * 0.7f, r.atten.y * albedo.y * 0.7f,
               r.atten.z * albedo.z * 0.7f};
}

// ---- live-ray packing (the whole-frame kernels, point 5) -------------------

struct Packed {
    int n_live;  // live rays of the block
    int rank;    // this thread's among them, in thread order
};

// The block's live count and this thread's rank.  Every thread reads every
// word of warp_live after the barrier, and the next call rewrites them
// before its own: the caller must pass a block barrier between two calls
// (packed_scan does on both of its returns).
__device__ __forceinline__ Packed pack_live(bool live) {
    __shared__ int warp_live[MAX_WARPS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
        const int c = warp_live[w];
        before += w < warp ? c : 0;
        total += c;
    }
    return {total, before + __popc(ballot & ((1u << lane) - 1u))};
}

// Slot k, two float4s of dynamic shared memory: o.xyz d.x | d.yz, then the
// best t and winning row the scan writes back.  Group k of LANES threads
// scans the ray of slot k, for k < n_scan (the live rays).
template <class P, int LANES>
__device__ __forceinline__ void scan_slot(const float* __restrict__ tab,
                                          const float* __restrict__ chunks,
                                          int n_chunks,
                                          const int* __restrict__ order,
                                          int n_scan, float4* slots) {
    const int k = threadIdx.x / LANES;
    const bool live = k < n_scan;
    Vec3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 0.0f};
    if (live) {
        const float4 a = slots[2 * k], b = slots[2 * k + 1];
        o = {a.x, a.y, a.z};
        d = {a.w, b.x, b.y};
    }
    const Vec3 id = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
    float bt = FLT_MAX_WGSL;
    int win = -1;
    cull_scan<P, LANES>(tab, chunks, n_chunks, order, live, id, P::ray(o, d),
                        bt, win);
    // every read of the slot came before the cull loop's first barrier
    if (live && threadIdx.x % LANES == 0) {
        slots[2 * k + 1].z = bt;
        slots[2 * k + 1].w = __int_as_float(win);
    }
}

// scan_slot at the most lanes, from LANES down to 1, that `fit`, the
// threads the block has for each ray it scans, allows (block-uniform).
template <class P, int LANES = PACK_MAX_LANES>
__device__ __forceinline__ void scan_fit(const float* __restrict__ tab,
                                         const float* __restrict__ chunks,
                                         int n_chunks,
                                         const int* __restrict__ order,
                                         int n_scan, int fit, float4* slots) {
    if constexpr (LANES > 1) {
        if (fit < LANES) {
            scan_fit<P, LANES / 2>(tab, chunks, n_chunks, order, n_scan, fit,
                                   slots);
            return;
        }
    }
    scan_slot<P, LANES>(tab, chunks, n_chunks, order, n_scan, slots);
}

// One bounce's closest-hit scan of a whole-frame kernel over P's table,
// for this thread's ray (o, d, alive), through the slots: live ray `rank`
// in slot `rank`, scanned at as many lanes (up to PACK_MAX_LANES) as the
// block's threads allow.  EVERY thread of the block calls it, a thread a
// ray.  Returns false, having changed nothing, when no ray of the block is
// alive (block-uniform); else a live ray's thread gets its best t and
// winning row (-1: no hit) in bt and win.
template <class P>
__device__ __forceinline__ bool packed_scan(const float* __restrict__ tab,
                                            const float* __restrict__ chunks,
                                            int n_chunks,
                                            const int* __restrict__ order,
                                            bool alive, Vec3 o, Vec3 d,
                                            float4* slots, float& bt,
                                            int& win) {
    const Packed pk = pack_live(alive);
    if (pk.n_live == 0) {
        // pack_live's reads of warp_live end here, before the caller's
        // next call (a next sample) rewrites the words
        __syncthreads();
        return false;
    }
    if (alive) {
        slots[2 * pk.rank] = make_float4(o.x, o.y, o.z, d.x);
        slots[2 * pk.rank + 1] = make_float4(d.y, d.z, 0.0f, 0.0f);
    }
    __syncthreads();
    scan_fit<P>(tab, chunks, n_chunks, order, pk.n_live,
                (int)blockDim.x / pk.n_live, slots);
    __syncthreads();
    if (alive) {
        const float4 s = slots[2 * pk.rank + 1];
        bt = s.z;
        win = __float_as_int(s.w);
    }
    return true;
}

}  // namespace rt
