// One bounce of the triangle path: front-to-back chunk-culled closest-hit
// scan, material resolve, scatter.  Shared by the wavefront kernels
// (tris_wave.cu) and the whole-frame kernels (tris_mono.cu), as the TPU
// package's kernels share rt/kernels/tris_kernel.py:_trace_bounce, so all of
// them agree per ray.
//
// One thread owns one ray and one block is one tile.  The tile is the unit of
// the chunk cull: a chunk of 32 triangles is scanned only when some live ray
// of the TILE enters its box nearer than its best hit (__syncthreads_or), and
// inside a live chunk every live ray of the tile scans all 32 triangles in
// ascending index with strict t < best, also a ray whose own box test
// failed.  The image depends on that union at box-surface roundings, so it
// is kept.
#pragma once

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
// Returns the winning chunk id, -1 on a miss or a dead ray.  TRACK_IDX (the
// recorder only): tid gets the winning row of the triangle table, -1 on a
// miss or a dead ray; without it tid is left alone and the scan carries no
// index.
template <bool TRACK_IDX>
__device__ int trace_bounce(const Tables& p, const int* __restrict__ order,
                            Ray& r, int& tid) {
    const bool alive = r.active > 0;
    const Vec3 o = r.o, d = r.d;
    const float idx = 1.0f / d.x, idy = 1.0f / d.y, idz = 1.0f / d.z;

    float bt = FLT_MAX_WGSL;
    Vec3 bn = {0.0f, 0.0f, 0.0f};
    float bmid = 0.0f;
    int wch = -1;
    if (TRACK_IDX) tid = -1;

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
                if (TRACK_IDX) tid = ci * p.chunk + k;
            }
        }
        // the chunk whose scan last improved best-t owns the hit
        if (bt < prev) wch = ci;
    }

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
