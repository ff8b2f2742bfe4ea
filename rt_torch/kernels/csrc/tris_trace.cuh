// One bounce of the triangle path: front-to-back chunk-culled closest-hit
// scan, material resolve, scatter.  Shared by the wavefront kernels
// (tris_wave.cu) and the whole-frame kernels (tris_mono.cu), as the TPU
// package's kernels share rt/kernels/tris_kernel.py:_trace_bounce, so all of
// them agree per ray.
//
// One thread (or LANES threads, point 4) owns a ray and one block is one
// tile.  The tile is the unit of the chunk cull: a chunk of 32 triangles is
// scanned only when some live ray of the TILE enters its box nearer than its
// best hit, chunks are visited in the tile's order, and inside a live chunk
// every live ray of the tile scans all 32 triangles in ascending index with
// strict t < best, also a ray whose own box test failed.  The image depends
// on that union at box-surface roundings, so it is kept: this function
// computes exactly what the plain version (tris_kernel.trace_bounce) does,
// bit for bit.
//
// How it does that work on Hopper:
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
// 2. A candidate's 32 triangles staged in shared memory, rows padded to 20
//    floats (the lanes of one ray then read distinct banks): the scan reads
//    a triangle as 128-bit shared loads, not 13 scalar loads through L1.
//    The copy is issued before the vote, so the vote's barrier publishes
//    it; two buffers alternate, so the next copy never overwrites rows a
//    slow warp still reads.
// 3. A scan with a compile-time trip count, unrolled by 4, that leaves a pair as soon as det, then u, then v reject it (the
//    warp leaves when all its lanes do).  A rejected pair's values are
//    never used, so no result changes; the reciprocal stays IEEE rcp.rn.
//    The winner's normal and material are read from its staged row once
//    the chunk is scanned.
// 4. LANES lanes a ray (the bounce kernel: 2): each tests a share of the
//    boxes and scans a share of the triangles, merged by shuffles (see
//    trace_bounce).  After a bounce the work of a tile is uneven (dragon at
//    512x512: 49 chunk scans a live tile on average, 390 in the heaviest),
//    and the kernel ends with the heaviest tiles' dependent chains.
//
// The constants were timed on an H100 against the alternatives (PERF.md):
// unroll 4 (1 and 2 slower, 8 the same), 2 lanes a ray in the bounce
// kernel (4 lose to occupancy; the first kernel keeps 1), fminf/fmaxf over
// the selects, no register bound (tris_wave.cu).
//
// Bound: operations (46 a ray-triangle pair, 24 a box test, the plain
// version's counts).  What limits the kernels now is the issue rate: ~80
// instructions a warp-pair on the full path (-fmad=false, the IEEE
// reciprocal's range check, the early exits' branches), ~30 a box test;
// on dragon the heaviest tiles' latency.  PERF.md has the numbers.
#pragma once

#include "rt_device.cuh"

namespace rt {

constexpr float EPSILON_TRIS = 1e-4f;
constexpr int TRI_COLS = 13;  // a(3) e1(3) e2(3) normal(3) mat_id
constexpr int CHUNK = 32;     // triangles a chunk (tris_kernel.CHUNK)
constexpr int BATCH = 32;     // visit entries a box batch: a mask bit each
// floats a staged triangle (13 used): 16-byte aligned rows whose first 16
// bytes fall on distinct banks for 4 consecutive rows, which the lanes of
// one ray read together
constexpr int TRI_ROW = 20;
constexpr int MAX_WARPS = 32;

struct Tables {
    const float* tab;     // (m_pad, 13), 16-byte aligned
    const float* mats;    // (n_mats, 5): albedo rgb, param, kind
    const float* chunks;  // (n_chunks, 6): box min xyz, max xyz
    int n_chunks;
    int n_mats;
    ScatterFlags flags;
};

// The block's staging area (6.6 KB).  Boxes, chunk ids and mask words are
// double-buffered by batch: batch b+1 is staged while batch b is tested.
struct TraceShared {
    float4 tri[2][CHUNK * TRI_ROW / 4];  // two candidates' triangles
    float4 box[2][BATCH][2];             // min xyz, max x | max yz, -, -
    int ci[2][BATCH];                    // the batch's chunk ids
    unsigned warp_mask[2][MAX_WARPS];    // each warp's OR of its masks
};

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
__device__ __forceinline__ void stage_batch(const Tables& p,
                                            const int* __restrict__ order,
                                            int base, float4 (*box)[2],
                                            int* ci_out) {
    const int nb = min(BATCH, p.n_chunks - base);
    for (int k = threadIdx.x; k < nb * 6; k += blockDim.x) {
        const int j = k / 6, c = k - 6 * j;
        const int ci = __ldg(order + base + j);
        reinterpret_cast<float*>(box[j])[c] = __ldg(p.chunks + ci * 6 + c);
        if (c == 0) ci_out[j] = ci;
    }
}

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
// the same result).  Lane g of the group tests the g-th share of a batch's
// boxes and scans triangles g, g + LANES, ... of a live chunk, from the
// ray's best t at the chunk's start; shuffles then take the least (t,
// index) of the shares.  That is the sequential scan's result: its winner
// is the first triangle, in index order, of least t below the best t
// before the chunk.  LANES warps share a tile's pairs where one ran them: a
// tile with much work (dragon, after a bounce) runs its dependent chains in
// 1/LANES of the time.
template <bool TRACK_IDX, int LANES = 1>
__device__ int trace_bounce(const Tables& p, const int* __restrict__ order,
                            Ray& r, int& tid) {
    static_assert(LANES == 1 || LANES == 2, "1 or 2 lanes a ray");
    constexpr int BOXES = BATCH / LANES;  // box tests a lane a batch
    constexpr int TRIS = CHUNK / LANES;   // pairs a lane a live chunk
    __shared__ TraceShared sh;
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

    // batch b's boxes, ids and mask words are in slot b & 1.  Every read of
    // a slot precedes a barrier that every thread passes before the slot is
    // written again (two batches on), also across calls
    stage_batch(p, order, 0, sh.box[0], sh.ci[0]);
    __syncthreads();
    for (int base = 0, slot = 0; base < p.n_chunks;
         base += BATCH, slot ^= 1) {
        const int nb = min(BATCH, p.n_chunks - base);
        // the next batch's loads overlap this one's tests
        if (base + BATCH < p.n_chunks)
            stage_batch(p, order, base + BATCH, sh.box[slot ^ 1],
                        sh.ci[slot ^ 1]);

        // this ray's bits (this lane's share of the batch): the live test
        // without its bt term
        float4 (*box)[2] = sh.box[slot];
        unsigned mask = 0u;
        if (alive) {
#pragma unroll
            for (int m = 0; m < BOXES; ++m) {
                const int j = half * BOXES + m;
                if (j < nb) {
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
            float* tri = reinterpret_cast<float*>(sh.tri[buf]);
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
            // the lanes that scan, both of each ray's pair (converged here)
            const unsigned lanes =
                LANES > 1 ? __ballot_sync(0xffffffffu, scan) : 0u;
            if (!scan) continue;

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

}  // namespace rt
