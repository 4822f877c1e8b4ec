// Native host-side data path for libsrcnn_tpu.
//
// The reference is a C++ library end-to-end; in this framework the
// device compute is JAX/XLA/Pallas, and THIS library covers the host hot
// path around it -- the work that feeds and drains the chip when serving:
//
//  * interleaved u8 RGB(A) <-> planar float32 YCbCr packing with the
//    reference's exact color math (`libsrcnn.cpp:233-308`), OpenMP-parallel
//  * resize contribution tables in double precision
//    (`frawscale.cpp:8-112` semantics, shared with the Python builder)
//  * a lock-free SPSC frame ring for streaming video producers
//
// Exposed as a plain C ABI consumed via ctypes (libsrcnn_tpu/io/native.py).
// Build: make -C native  (produces libsrcnn_host.so)

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Color packing (reference math, `libsrcnn.cpp:250-264` / `:293-305`)
// ---------------------------------------------------------------------------

// u8 interleaved [h*w*d] -> planar f32 [d][h*w] YCbCr(+A).
void srcnn_rgb_to_ycbcr(const uint8_t* src, float* dst,
                        int64_t npix, int32_t depth) {
    float* Y = dst;
    float* Cb = dst + npix;
    float* Cr = dst + 2 * npix;
    float* A = depth == 4 ? dst + 3 * npix : nullptr;
#pragma omp parallel for
    for (int64_t i = 0; i < npix; ++i) {
        const uint8_t* p = src + i * depth;
        float r = (float)p[0], g = (float)p[1], b = (float)p[2];
        Y[i] = 0.299f * r + 0.587f * g + 0.114f * b;
        Cb[i] = 128.f - 0.1687f * r - 0.3313f * g + 0.5f * b;
        Cr[i] = 128.f + 0.5f * r - 0.4187f * g - 0.0813f * b;
        if (A) A[i] = (float)p[3];
    }
}

static inline uint8_t trunc_u8(float v) {
    v = v < 255.f ? v : 255.f;
    v = v > 0.f ? v : 0.f;
    return (uint8_t)v;  // C truncating cast, as the reference emits u8
}

// planar f32 [d][h*w] YCbCr(+A) -> u8 interleaved [h*w*d], rational-approx
// inverse 45/32, 11/32, 23/32, 113/64 with [0,255] clamp.
void srcnn_ycbcr_to_rgb(const float* src, uint8_t* dst,
                        int64_t npix, int32_t depth) {
    const float* Y = src;
    const float* Cb = src + npix;
    const float* Cr = src + 2 * npix;
    const float* A = depth == 4 ? src + 3 * npix : nullptr;
#pragma omp parallel for
    for (int64_t i = 0; i < npix; ++i) {
        float y = Y[i];
        float cb = Cb[i] - 128.f;
        float cr = Cr[i] - 128.f;
        uint8_t* p = dst + i * depth;
        p[0] = trunc_u8(y + 45.f * cr / 32.f);
        p[1] = trunc_u8(y - (11.f * cb + 23.f * cr) / 32.f);
        p[2] = trunc_u8(y + 113.f * cb / 64.f);
        if (A) p[3] = trunc_u8(A[i]);
    }
}

// ---------------------------------------------------------------------------
// Contribution tables (double precision, `frawscale.cpp:8-112` semantics)
// ---------------------------------------------------------------------------

static double filter_eval(int32_t type, double x) {
    x = fabs(x);
    switch (type) {
        case 0:  // box, width 0.5
            return x <= 0.5 ? 1.0 : 0.0;
        case 1:  // bilinear, width 1
            return x < 1.0 ? 1.0 - x : 0.0;
        case 2: {  // Mitchell-Netravali b=c=1/3, width 2
            const double b = 1.0 / 3.0, c = 1.0 / 3.0;
            const double p0 = (6 - 2 * b) / 6, p2 = (-18 + 12 * b + 6 * c) / 6;
            const double p3 = (12 - 9 * b - 6 * c) / 6;
            const double q0 = (8 * b + 24 * c) / 6, q1 = (-12 * b - 48 * c) / 6;
            const double q2 = (6 * b + 30 * c) / 6, q3 = (-b - 6 * c) / 6;
            if (x < 1) return p0 + x * x * (p2 + x * p3);
            if (x < 2) return q0 + x * (q1 + x * (q2 + x * q3));
            return 0.0;
        }
        case 3: {  // lanczos3, width 3
            if (x >= 3.0) return 0.0;
            auto sinc = [](double v) {
                if (v == 0.0) return 1.0;
                v *= 3.1415926535897932384626433832795;
                return sin(v) / v;
            };
            return sinc(x) * sinc(x / 3.0);
        }
        case 4: {  // cubic b-spline, width 2
            if (x < 1) return (4 + x * x * (-6 + 3 * x)) / 6;
            if (x < 2) {
                double t = 2 - x;
                return t * t * t / 6;
            }
            return 0.0;
        }
    }
    return 0.0;
}

static double filter_width(int32_t type) {
    switch (type) {
        case 0: return 0.5;
        case 1: return 1.0;
        case 3: return 3.0;
        default: return 2.0;
    }
}

// Returns the window size; fills left[dst] and weights[dst*window].
int32_t srcnn_contribution_table(int32_t filter_type, int64_t dst_size,
                                 int64_t src_size, int32_t* left,
                                 double* weights) {
    double fw = filter_width(filter_type);
    double scale = (double)dst_size / (double)src_size;
    double width = fw, fscale = 1.0;
    if (scale < 1.0) { width = fw / scale; fscale = scale; }
    int32_t window = 2 * (int32_t)ceil(width) + 1;
    double offset = (0.5 / scale) - 0.5;

    for (int64_t u = 0; u < dst_size; ++u) {
        double center = (double)u / scale + offset;
        int64_t ileft = (int64_t)floor(center - width);
        if (ileft < 0) ileft = 0;
        int64_t iright = (int64_t)ceil(center + width);
        if (iright > src_size - 1) iright = src_size - 1;
        if (iright - ileft + 1 > window) ileft++;  // reference quirk: always left

        double total = 0.0;
        double* wrow = weights + u * window;
        for (int32_t k = 0; k < window; ++k) wrow[k] = 0.0;
        for (int64_t s = ileft; s <= iright; ++s) {
            double wv = fscale * filter_eval(filter_type, fscale * (center - (double)s));
            wrow[s - ileft] = wv;
            total += wv;
        }
        if (total > 0.0 && total != 1.0)
            for (int64_t s = ileft; s <= iright; ++s) wrow[s - ileft] /= total;
        left[u] = (int32_t)ileft;
    }
    return window;
}

// ---------------------------------------------------------------------------
// Lock-free SPSC frame ring (streaming video producer -> device feeder)
// ---------------------------------------------------------------------------

struct FrameRing {
    std::vector<uint8_t> data;
    std::vector<int64_t> sizes;
    int64_t frame_cap;
    int32_t nslots;
    std::atomic<int64_t> head{0};  // next write
    std::atomic<int64_t> tail{0};  // next read
};

void* srcnn_ring_create(int64_t frame_bytes, int32_t nslots) {
    auto* r = new FrameRing();
    r->frame_cap = frame_bytes;
    r->nslots = nslots;
    r->data.resize((size_t)frame_bytes * nslots);
    r->sizes.resize(nslots, 0);
    return r;
}

void srcnn_ring_destroy(void* ring) { delete (FrameRing*)ring; }

// 1 on success, 0 if full or frame too large.
int32_t srcnn_ring_push(void* ring, const uint8_t* frame, int64_t nbytes) {
    auto* r = (FrameRing*)ring;
    if (nbytes > r->frame_cap) return 0;
    int64_t h = r->head.load(std::memory_order_relaxed);
    int64_t t = r->tail.load(std::memory_order_acquire);
    if (h - t >= r->nslots) return 0;  // full
    int32_t slot = (int32_t)(h % r->nslots);
    memcpy(r->data.data() + (size_t)slot * r->frame_cap, frame, nbytes);
    r->sizes[slot] = nbytes;
    r->head.store(h + 1, std::memory_order_release);
    return 1;
}

// Returns bytes popped (0 if empty).
int64_t srcnn_ring_pop(void* ring, uint8_t* out, int64_t cap) {
    auto* r = (FrameRing*)ring;
    int64_t t = r->tail.load(std::memory_order_relaxed);
    int64_t h = r->head.load(std::memory_order_acquire);
    if (t >= h) return 0;  // empty
    int32_t slot = (int32_t)(t % r->nslots);
    int64_t n = r->sizes[slot];
    if (n > cap) return -1;
    memcpy(out, r->data.data() + (size_t)slot * r->frame_cap, n);
    r->tail.store(t + 1, std::memory_order_release);
    return n;
}

int32_t srcnn_ring_size(void* ring) {
    auto* r = (FrameRing*)ring;
    return (int32_t)(r->head.load(std::memory_order_acquire) -
                     r->tail.load(std::memory_order_acquire));
}

int32_t srcnn_host_version() { return 10040; }  // parity: 0.1.10.40

}  // extern "C"
