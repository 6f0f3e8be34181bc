// sphnative — native host-runtime companion library for sphjax.
//
// The reference's host runtime is C++ (driver main.cpp, renderer display.cpp,
// host-side state init in simulator.cu:411-460). This library provides the
// native equivalents of those host-side pieces; the device compute path
// itself is JAX/XLA/Pallas. Exposed via a C ABI and loaded from
// Python with ctypes (sphjax/utils/native.py); every entry point has a pure
// Python fallback so the framework works without a compiler present.
//
// Contents:
//   * sph_reference_random_init — bit-exact replica of the reference's
//     unseeded libc rand() particle placement (simulator.cu:430-437):
//     rand()/RAND_MAX * (box-2) + 1 per coordinate, x,y,z order per particle.
//   * sph_grid_init — the 0.9h-spacing lattice (simulator.cu:438-453).
//   * sph_render_frame — the free-mode software rasterizer (black clear,
//     white box wireframe, blue 3px points, glFrustum(-2,2,-2,2,1,100)
//     translated (-5,-5,-15); display.cpp:35-91).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Reference-parity random init (simulator.cu:430-437). Uses libc rand() with
// whatever seed state the process has (the reference never seeds → glibc
// default seed 1). Pass seed >= 0 to srand() first, or -1 to leave state.
void sph_reference_random_init(int n, float box_dim, int seed, float *out) {
    if (seed >= 0) {
        srand(static_cast<unsigned>(seed));
    }
    for (int i = 0; i < n; i++) {
        float x = rand() / (float)RAND_MAX * (box_dim - 2.f) + 1.f;
        float y = rand() / (float)RAND_MAX * (box_dim - 2.f) + 1.f;
        float z = rand() / (float)RAND_MAX * (box_dim - 2.f) + 1.f;
        out[3 * i + 0] = x;
        out[3 * i + 1] = y;
        out[3 * i + 2] = z;
    }
}

// Lattice init (simulator.cu:438-453): spacing 0.9h, origin (h,h,h),
// z-fastest fill, truncated at n. Returns number written.
int sph_grid_init(int n, float h, float box_dim, float *out) {
    float spacing = 0.9f * h;
    int nx = (int)std::floor((box_dim - 2 * h) / spacing) + 1;
    int count = 0;
    for (int x = 0; x < nx && count < n; x++) {
        for (int y = 0; y < nx && count < n; y++) {
            for (int z = 0; z < nx && count < n; z++) {
                out[3 * count + 0] = h + spacing * x;
                out[3 * count + 1] = h + spacing * y;
                out[3 * count + 2] = h + spacing * z;
                count++;
            }
        }
    }
    return count;
}

// Software rasterizer matching sphjax/viz/render.py (and display.cpp:35-91).
static const int W = 800, H = 600;
static const float NEARP = 1.0f, HALF = 2.0f;
static const float CAM[3] = {-5.f, -5.f, -15.f};

static inline bool project(const float *p, float *px, float *py, float *depth) {
    float vx = p[0] + CAM[0], vy = p[1] + CAM[1], vz = p[2] + CAM[2];
    float z = -vz;
    if (z < 1e-6f) z = 1e-6f;
    *depth = z;
    float ndc_x = (NEARP * vx / z) / HALF;
    float ndc_y = (NEARP * vy / z) / HALF;
    *px = (ndc_x * 0.5f + 0.5f) * W;
    *py = (1.0f - (ndc_y * 0.5f + 0.5f)) * H;
    return true;
}

static void draw_box_wireframe(uint8_t *img) {
    static const float verts[8][3] = {
        {0, 0, 0}, {10, 0, 0}, {10, 10, 0}, {0, 10, 0},
        {0, 0, 10}, {10, 0, 10}, {10, 10, 10}, {0, 10, 10}};
    static const int edges[12][2] = {{0, 1}, {1, 2}, {2, 3}, {3, 0},
                                     {4, 5}, {5, 6}, {6, 7}, {7, 4},
                                     {0, 4}, {1, 5}, {2, 6}, {3, 7}};
    for (int e = 0; e < 12; e++) {
        const float *a = verts[edges[e][0]];
        const float *b = verts[edges[e][1]];
        for (int s = 0; s < 400; s++) {
            float t = s / 399.f;
            float p[3] = {a[0] * (1 - t) + b[0] * t, a[1] * (1 - t) + b[1] * t,
                          a[2] * (1 - t) + b[2] * t};
            float px, py, d;
            project(p, &px, &py, &d);
            int xi = (int)px, yi = (int)py;
            if (xi >= 0 && xi < W && yi >= 0 && yi < H) {
                uint8_t *q = img + 3 * ((size_t)yi * W + xi);
                q[0] = q[1] = q[2] = 255;
            }
        }
    }
}

void sph_render_frame(const float *pos, int n, uint8_t *img /* H*W*3 */) {
    std::memset(img, 0, (size_t)H * W * 3);
    draw_box_wireframe(img);

    for (int i = 0; i < n; i++) {
        float px, py, d;
        project(pos + 3 * i, &px, &py, &d);
        if (d <= NEARP) continue;
        int xi = (int)px, yi = (int)py;
        if (xi < 1 || xi >= W - 1 || yi < 1 || yi >= H - 1) continue;
        for (int dy = -1; dy <= 1; dy++) {
            for (int dx = -1; dx <= 1; dx++) {
                uint8_t *q = img + 3 * ((size_t)(yi + dy) * W + (xi + dx));
                q[0] = 0;
                q[1] = 0;
                q[2] = 255;
            }
        }
    }
}

// Rasterize from DEVICE-projected packed pixel coords
// (sphjax/viz/project.py: bit 20 = inside flag, bits 19..10 = y, 9..0 = x)
// — the 4-bytes-per-particle frame stream of the chunked free mode.
void sph_render_packed(const int32_t *packed, int n, uint8_t *img) {
    std::memset(img, 0, (size_t)H * W * 3);
    draw_box_wireframe(img);
    for (int i = 0; i < n; i++) {
        int32_t p = packed[i];
        if (!(p & (1 << 20))) continue;
        int xi = p & 0x3FF, yi = (p >> 10) & 0x3FF;
        for (int dy = -1; dy <= 1; dy++) {
            for (int dx = -1; dx <= 1; dx++) {
                uint8_t *q = img + 3 * ((size_t)(yi + dy) * W + (xi + dx));
                q[0] = 0;
                q[1] = 0;
                q[2] = 255;
            }
        }
    }
}

int sph_native_abi_version(void) { return 2; }

}  // extern "C"
