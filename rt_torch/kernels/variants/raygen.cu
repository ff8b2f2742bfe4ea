// K4 (wave_raygen_kernel) in other launch shapes, each behind its own C
// entry, for `python -m rt_torch.variants raygen`: K4's earlier tile launch
// (a thread a pixel, a block a render tile), a flat grid (each thread's
// index divided into frame, row and column, P pixels a thread, optionally
// capped at `cap` blocks an SM and looping) and strips of a row (P pixels
// a thread).  Every variant calls generate_ray() per pixel as K4 does and
// stores a thread's P pixels with one P-wide store a plane (the width a
// multiple of P).  Built by rt_torch/variants.py with -I ../csrc.
#include "tris_wave.cu"

namespace rt_variants {
using rt::CameraRow;
using rt::Vec3;

template <int P> struct Store;
template <> struct Store<1> {
    static __device__ void at(float* p, const float* v) { p[0] = v[0]; }
};
template <> struct Store<2> {
    static __device__ void at(float* p, const float* v) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    }
};
template <> struct Store<4> {
    static __device__ void at(float* p, const float* v) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
};

// one block a th x tw render tile, block th * tw threads
__global__ void tile_kernel(CameraRow cam, const uint32_t* __restrict__ times,
                            int height, int width, int height_pad,
                            int width_pad, int tw, int nd,
                            float* __restrict__ od, float* __restrict__ pdy,
                            uint32_t* __restrict__ st) {
    const int ly = threadIdx.x / tw, lx = threadIdx.x % tw;
    const int th = blockDim.x / tw;
    const int row = blockIdx.y * th + ly;
    const int col = blockIdx.x * tw + lx;
    const size_t n = (size_t)gridDim.z * height_pad * width_pad;
    const size_t i =
        ((size_t)blockIdx.z * height_pad + row) * width_pad + col;
    uint32_t state;
    Vec3 o, d;
    rt::generate_ray(cam, (uint32_t)col, (uint32_t)row, height, width,
                     __ldg(times + blockIdx.z), nd != 0, state, o, d);
    od[0 * n + i] = o.x;
    od[1 * n + i] = o.y;
    od[2 * n + i] = o.z;
    od[3 * n + i] = d.x;
    od[4 * n + i] = d.y;
    od[5 * n + i] = d.z;
    pdy[i] = d.y;
    st[i] = state;
}

// the 8 words of pixels col0 .. col0 + P - 1 of a row, by plane
template <int P>
__device__ __forceinline__ void rays(CameraRow cam, unsigned col0,
                                     unsigned row, int height, int width,
                                     uint32_t time, int nd,
                                     float (&v)[8][P]) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
        uint32_t state;
        Vec3 o, d;
        rt::generate_ray(cam, col0 + p, row, height, width, time, nd != 0,
                         state, o, d);
        v[0][p] = o.x;
        v[1][p] = o.y;
        v[2][p] = o.z;
        v[3][p] = d.x;
        v[4][p] = d.y;
        v[5][p] = d.z;
        v[6][p] = d.y;
        v[7][p] = __uint_as_float(state);
    }
}

template <int P>
__device__ __forceinline__ void store(float* od, float* pdy, uint32_t* st,
                                      size_t n, size_t i0,
                                      float (&v)[8][P]) {
#pragma unroll
    for (int k = 0; k < 6; ++k) Store<P>::at(od + k * n + i0, v[k]);
    Store<P>::at(pdy + i0, v[6]);
    Store<P>::at(reinterpret_cast<float*>(st) + i0, v[7]);
}

// thread g of a grid-stride loop takes pixels g * P .. g * P + P - 1
template <int P, int T>
__global__ void __launch_bounds__(T)
flat_kernel(CameraRow cam, const uint32_t* __restrict__ times, int height,
            int width, int height_pad, int width_pad, unsigned n, int nd,
            float* __restrict__ od, float* __restrict__ pdy,
            uint32_t* __restrict__ st) {
    const unsigned frame = (unsigned)height_pad * width_pad;
    for (unsigned g = blockIdx.x * T + threadIdx.x; g < n / P;
         g += gridDim.x * T) {
        const unsigned i0 = g * P;
        const unsigned f = i0 / frame, rem = i0 - f * frame;
        const unsigned row = rem / width_pad, col = rem - row * width_pad;
        float v[8][P];
        rays<P>(cam, col, row, height, width, __ldg(times + f), nd, v);
        store<P>(od, pdy, st, n, i0, v);
    }
}

// grid (ceil(Wp / (P * T)), Hp, F): K4's own launch at P = 1, T = 128
template <int P, int T>
__global__ void __launch_bounds__(T)
strip_kernel(CameraRow cam, const uint32_t* __restrict__ times, int height,
             int width, int height_pad, int width_pad, unsigned n, int nd,
             float* __restrict__ od, float* __restrict__ pdy,
             uint32_t* __restrict__ st) {
    const unsigned col0 = (blockIdx.x * T + threadIdx.x) * P;
    if (col0 >= (unsigned)width_pad) return;
    const uint32_t time = __ldg(times + blockIdx.z);
    const unsigned i0 =
        (blockIdx.z * (unsigned)height_pad + blockIdx.y) * width_pad + col0;
    float v[8][P];
    rays<P>(cam, col0, blockIdx.y, height, width, time, nd, v);
    store<P>(od, pdy, st, n, i0, v);
}

CameraRow camera(const float* cam) {
    CameraRow r;
    for (int c = 0; c < 20; ++c) r.v[c] = cam[c];
    return r;
}

template <int P, int T>
int flat(int cap, const float* cam, const uint32_t* times, float* od,
         float* pdy, uint32_t* st, int height, int width, int hp, int wp,
         int nf, int nd, cudaStream_t stream) {
    const unsigned n = (unsigned)nf * hp * wp;
    unsigned blocks = (n / P + T - 1) / T;
    if (cap && blocks > (unsigned)cap * 132) blocks = cap * 132;
    flat_kernel<P, T><<<blocks, T, 0, stream>>>(
        camera(cam), times, height, width, hp, wp, n, nd, od, pdy, st);
    return (int)cudaGetLastError();
}

template <int P, int T>
int strip(const float* cam, const uint32_t* times, float* od, float* pdy,
          uint32_t* st, int height, int width, int hp, int wp, int nf,
          int nd, cudaStream_t stream) {
    const unsigned n = (unsigned)nf * hp * wp;
    const dim3 grid((wp / P + T - 1) / T, hp, nf);
    strip_kernel<P, T><<<grid, T, 0, stream>>>(
        camera(cam), times, height, width, hp, wp, n, nd, od, pdy, st);
    return (int)cudaGetLastError();
}

}  // namespace rt_variants

// Each entry: camera row, times, the 8 planes (od, pdy, state), the frame,
// padded frame and frame count, normalize_defocus_dir, stream; -1 for a
// shape not built.
extern "C" int rv_tile(int th, int tw, const float* cam,
                       const uint32_t* times, float* od, float* pdy,
                       uint32_t* st, int height, int width, int hp, int wp,
                       int nf, int nd, void* stream) {
    const dim3 grid(wp / tw, hp / th, nf);
    rt_variants::tile_kernel<<<grid, th * tw, 0, (cudaStream_t)stream>>>(
        rt_variants::camera(cam), times, height, width, hp, wp, tw, nd, od,
        pdy, st);
    return (int)cudaGetLastError();
}

extern "C" int rv_flat(int p, int t, int cap, const float* cam,
                       const uint32_t* times, float* od, float* pdy,
                       uint32_t* st, int height, int width, int hp, int wp,
                       int nf, int nd, void* stream) {
#define RV_FLAT(P, T)                                                      \
    if (p == P && t == T)                                                  \
        return rt_variants::flat<P, T>(cap, cam, times, od, pdy, st,       \
                                       height, width, hp, wp, nf, nd,      \
                                       (cudaStream_t)stream);
    RV_FLAT(1, 128) RV_FLAT(1, 256) RV_FLAT(2, 128) RV_FLAT(2, 256)
    RV_FLAT(4, 128) RV_FLAT(4, 256)
    return -1;
}

extern "C" int rv_strip(int p, int t, const float* cam,
                        const uint32_t* times, float* od, float* pdy,
                        uint32_t* st, int height, int width, int hp, int wp,
                        int nf, int nd, void* stream) {
#define RV_STRIP(P, T)                                                     \
    if (p == P && t == T)                                                  \
        return rt_variants::strip<P, T>(cam, times, od, pdy, st, height,   \
                                        width, hp, wp, nf, nd,             \
                                        (cudaStream_t)stream);
    RV_STRIP(1, 64) RV_STRIP(1, 128) RV_STRIP(1, 256) RV_STRIP(1, 512)
    RV_STRIP(2, 32) RV_STRIP(2, 64) RV_STRIP(2, 128) RV_STRIP(2, 256)
    RV_STRIP(4, 32) RV_STRIP(4, 64) RV_STRIP(4, 128)
    return -1;
}
