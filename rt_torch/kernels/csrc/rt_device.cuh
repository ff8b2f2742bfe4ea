// Device library shared by the path-tracing kernels: PCG RNG, vector math,
// camera ray generation, the three-way material scatter and the sky.
//
// Replaces the in-kernel library of the TPU package
// (rt/kernels/plane_math.py and rt/kernels/tracer_common.py:generate_rays /
// scatter).  There every quantity is a (th, tw) plane and divergent arms are
// computed for all lanes and selected; here one thread owns one ray, so the
// same arithmetic is written on scalars and a thread evaluates only the arm
// its material takes.  Each expression keeps the operation order of the
// plain PyTorch version (rt_torch/kernels/tracer_common.py), and the file
// is compiled with -fmad=false, so kernel and plain version agree bit for
// bit.
#pragma once

#include <stdint.h>

namespace rt {

struct Vec3 {
    float x, y, z;
};

// One ray of a kernel's working set.
struct Ray {
    uint32_t state;
    Vec3 o, d, atten;
    int active;
};

constexpr float FLT_MAX_WGSL = 3.40282e38f;  // the shader's constant

// Camera row layout (rt_torch/kernels/tracer_common.py).
struct CameraRow {
    float v[20];
};
constexpr int CAM_EYE = 0, CAM_DIR = 4, CAM_UP = 8, CAM_RIGHT = 12;
constexpr int CAM_FL = 16, CAM_BLUR = 17, CAM_TAN = 19;

// ---- RNG: wrapping uint32 PCG, f32 divisor 2^32 --------------------------

__device__ __forceinline__ uint32_t rng_step(uint32_t s) {
    uint32_t old = s + 747796405u + 2891336453u;
    uint32_t word = ((old >> ((old >> 28u) + 4u)) ^ old) * 277803737u;
    return (word >> 22u) ^ word;
}

__device__ __forceinline__ float rng_float(uint32_t& s) {
    s = rng_step(s);
    return __uint2float_rn(s) / 4294967296.0f;
}

// ---- vec3 ----------------------------------------------------------------

__device__ __forceinline__ float dot3(Vec3 a, Vec3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ Vec3 add3(Vec3 a, Vec3 b) {
    return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ Vec3 sub3(Vec3 a, Vec3 b) {
    return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ Vec3 scale3(Vec3 a, float k) {
    return {a.x * k, a.y * k, a.z * k};
}
__device__ __forceinline__ Vec3 neg3(Vec3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ Vec3 cross3(Vec3 a, Vec3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
// division, not reciprocal-multiply; no zero guard (NaN on a zero vector)
__device__ __forceinline__ Vec3 normalize3(Vec3 a) {
    float ln = sqrtf(dot3(a, a));
    return {a.x / ln, a.y / ln, a.z / ln};
}
__device__ __forceinline__ Vec3 reflect3(Vec3 v, Vec3 n) {
    float k = 2.0f * dot3(v, n);
    return sub3(v, scale3(n, k));
}
// minimum(x, 1) that propagates NaN (fminf would drop it)
__device__ __forceinline__ float min_one(float x) {
    return x > 1.0f ? 1.0f : x;
}
__device__ __forceinline__ Vec3 refract3(Vec3 uv, Vec3 n, float ir) {
    float cos_theta = min_one(dot3(neg3(uv), n));
    Vec3 perp = scale3(add3(uv, scale3(n, cos_theta)), ir);
    float ln = sqrtf(dot3(perp, perp));
    float par_k = -sqrtf(fabsf(1.0f - ln * ln));
    return add3(perp, scale3(n, par_k));
}
// fifth power as the multiply chain (x*x)*(x*x)*x, as in the plain version
__device__ __forceinline__ float schlick(float cosine, float ref_idx) {
    float r0 = (1.0f - ref_idx) / (1.0f + ref_idx);
    r0 = r0 * r0;
    float x = 1.0f - cosine;
    float x2 = x * x;
    return r0 + (1.0f - r0) * (x2 * x2 * x);
}
__device__ __forceinline__ float fract(float x) { return x - floorf(x); }

// min/max that return the non-NaN operand (WGSL semantics), written as the
// plain versions write them; the box tests use them
__device__ __forceinline__ float fmin_w(float a, float b) {
    return (isnan(a) || b < a) ? b : a;
}
__device__ __forceinline__ float fmax_w(float a, float b) {
    return (isnan(a) || b > a) ? b : a;
}

__device__ __forceinline__ void normalize2(float& a, float& b) {
    float ln = sqrtf(a * a + b * b);
    a = a / ln;
    b = b / ln;
}
__device__ __forceinline__ void normalize4(float* a) {
    float ln = sqrtf(a[0] * a[0] + a[1] * a[1] + a[2] * a[2] + a[3] * a[3]);
    for (int c = 0; c < 4; ++c) a[c] = a[c] / ln;
}

// ---- camera ray generation -------------------------------------------------
// Seed (x*height + y)*time, AA jitter, uv, make_ray with the 4-D normalize
// quirk (the camera's w components take part), 3-draw defocus.  tan(fov/2)
// arrives precomputed in the camera row.

__device__ __forceinline__ void generate_ray(
        const CameraRow& cam, uint32_t x, uint32_t y, int height, int width,
        uint32_t time, bool normalize_defocus_dir, uint32_t& state, Vec3& o,
        Vec3& d) {
    state = (x * (uint32_t)height + y) * time;

    float jx = rng_float(state);
    float jy = rng_float(state);
    normalize2(jx, jy);
    float px = (float)x + 0.5f + jx;
    float py = (float)y + 0.5f + jy;

    float ux = px / (float)(width - 1);
    float uy = py / (float)(height - 1);
    float aspect = (float)width / (float)height;
    float uvx = (2.0f * ux - 1.0f) * aspect;
    float uvy = -(2.0f * uy - 1.0f);

    float k = cam.v[CAM_TAN];
    float kx = uvx * k;
    float ky = uvy * k;
    float d4[4], o4[4], focus[4];
    for (int c = 0; c < 4; ++c)
        d4[c] = cam.v[CAM_RIGHT + c] * kx + cam.v[CAM_UP + c] * ky
                + cam.v[CAM_DIR + c];
    normalize4(d4);

    float fl = cam.v[CAM_FL];
    for (int c = 0; c < 4; ++c) {
        o4[c] = 0.0f + cam.v[CAM_EYE + c];
        focus[c] = o4[c] + d4[c] * fl;
    }

    float vx = rng_float(state);
    float vy = rng_float(state);
    normalize2(vx, vy);
    float r = rng_float(state);
    r = r * cam.v[CAM_BLUR];
    o4[0] = o4[0] + vx * r;
    o4[1] = o4[1] + vy * r;
    o4[3] = o4[3] + 1.0f;

    for (int c = 0; c < 4; ++c) d4[c] = focus[c] - o4[c];
    if (normalize_defocus_dir) normalize4(d4);
    o = {o4[0], o4[1], o4[2]};
    d = {d4[0], d4[1], d4[2]};
}

// ---- material scatter ------------------------------------------------------
// RNG draws: lambertian and metal consume 3; dielectric consumes 1 unless
// total internal reflection, then none.  Arm choice repeats the plain
// version's select chain, including which arm an unknown kind falls into
// when the scene lacks metal or dielectric materials.

struct ScatterFlags {
    int normalize_reflect_in;
    int has_metal;
    int has_dielectric;
};

__device__ __forceinline__ void scatter(
        uint32_t& state, Vec3& d, Vec3 normal, bool front_face, float param,
        int kind, const ScatterFlags& f) {
    uint32_t s = state;
    float f1 = rng_float(s);
    uint32_t s1 = s;

    bool lam = kind == 1 || (!f.has_metal && !f.has_dielectric);
    bool met = !lam && f.has_metal && (kind == 2 || !f.has_dielectric);
    if (lam || met) {
        float f2 = rng_float(s);
        float f3 = rng_float(s);
        Vec3 hemi = normalize3({f1, f2, f3});
        if (!(dot3(hemi, normal) > 0.0f)) hemi = neg3(hemi);
        state = s;
        if (lam) {
            d = hemi;
        } else {
            Vec3 refl_in = f.normalize_reflect_in ? normalize3(d) : d;
            d = normalize3(add3(reflect3(refl_in, normal),
                                scale3(hemi, param)));
        }
        return;
    }
    float ir = front_face ? 1.0f / param : param;
    float cos_theta = min_one(dot3(neg3(d), normal));
    float sin_theta = sqrtf(1.0f - cos_theta * cos_theta);
    bool cannot_refract = ir * sin_theta > 1.0f;
    bool use_reflect = cannot_refract || (schlick(cos_theta, ir) > fract(f1));
    d = use_reflect ? normalize3(reflect3(d, normal))
                    : normalize3(refract3(d, normal, ir));
    if (!cannot_refract) state = s1;
}

// ---- sky --------------------------------------------------------------------
// color = atten * mix(SKY, BLUE, dy*0.5 + 0.5), unclamped.

__device__ __forceinline__ Vec3 sky_times_atten(float dy, Vec3 atten) {
    float t = dy * 0.5f + 0.5f;
    float u = 1.0f - t;
    return {atten.x * (0.54f * u + 0.54f * t),
            atten.y * (0.86f * u + 0.7f * t),
            atten.z * (0.92f * u + 0.98f * t)};
}

// ---- whole-frame kernels ----------------------------------------------------
// One launch traces a frame: one thread owns one pixel of a (th, tw) tile,
// grid (Wp/tw, Hp/th), block th*tw.

// What a frame's launch needs besides the tables.
struct Frame {
    CameraRow cam;
    uint32_t time;
    int row0;  // global row of the launch's first row (seed and uv math)
    int height, width, height_pad, width_pad, tw;
    int bounces, spp;
    int normalize_defocus_dir, sky_from_final_dir;
    ScatterFlags flags;
};

struct Pixel {
    int row, col;
    uint32_t state;  // RNG state, carried across samples
    Vec3 o, d;       // the primary ray, traced anew by every sample
};

__device__ __forceinline__ Pixel primary_ray(const Frame& f) {
    Pixel p;
    const int th = blockDim.x / f.tw;
    p.row = blockIdx.y * th + threadIdx.x / f.tw;
    p.col = blockIdx.x * f.tw + threadIdx.x % f.tw;
    generate_ray(f.cam, (uint32_t)p.col, (uint32_t)(p.row + f.row0), f.height,
                 f.width, f.time, f.normalize_defocus_dir != 0, p.state, p.o,
                 p.d);
    return p;
}

__device__ __forceinline__ void store_color(const Frame& f, const Pixel& p,
                                            Vec3 acc, float* out) {
    if (f.spp > 1) {
        // a true divide: x / 3 and x * (1/3) round differently
        float n = (float)f.spp;
        acc = {acc.x / n, acc.y / n, acc.z / n};
    }
    const size_t plane = (size_t)f.height_pad * f.width_pad;
    const size_t i = (size_t)p.row * f.width_pad + p.col;
    out[0 * plane + i] = acc.x;
    out[1 * plane + i] = acc.y;
    out[2 * plane + i] = acc.z;
}

__device__ __forceinline__ Vec3 sample_color(const Frame& f, const Pixel& p,
                                             const Ray& r) {
    return sky_times_atten(f.sky_from_final_dir ? r.d.y : p.d.y, r.atten);
}

inline Frame make_frame(const float* cam, uint32_t time, int row0, int height,
                        int width, int height_pad, int width_pad, int tw,
                        int bounces, int spp, int normalize_defocus_dir,
                        int normalize_reflect_in, int has_metal,
                        int has_dielectric, int sky_from_final_dir) {
    Frame f;
    for (int c = 0; c < 20; ++c) f.cam.v[c] = cam[c];
    f.time = time;
    f.row0 = row0;
    f.height = height;
    f.width = width;
    f.height_pad = height_pad;
    f.width_pad = width_pad;
    f.tw = tw;
    f.bounces = bounces;
    f.spp = spp;
    f.normalize_defocus_dir = normalize_defocus_dir;
    f.sky_from_final_dir = sky_from_final_dir;
    f.flags = {normalize_reflect_in, has_metal, has_dielectric};
    return f;
}

}  // namespace rt
