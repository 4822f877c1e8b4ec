/* libsrcnn_tpu C ABI (see capi.cpp) — the JAX framework behind the
 * reference's two-function library surface (`libsrcnn.h:37-54`).
 *
 * Link against libsrcnn_tpu_c.so (build: `make -C native capi`). The
 * library hosts an embedded CPython interpreter on first use; set
 * PYTHONPATH to a checkout if the libsrcnn_tpu package is not installed.
 * Device selection follows the JAX environment (JAX_PLATFORMS=cpu pins
 * to host; otherwise JAX picks its default device, the GPU if present).
 *
 * Differences from the reference header, stated once:
 *   - out-params are pointers, not C++ references (same machine ABI,
 *     callable from plain C);
 *   - output buffers are malloc()'d — free them with SRCNN_FreeBuffer.
 */
#ifndef LIBSRCNN_TPU_C_H
#define LIBSRCNN_TPU_C_H

#ifdef __cplusplus
extern "C" {
#endif

/* Filter enum values match the reference (`libsrcnn.h:37-44`). */
typedef enum {
    SRCNN_TPU_F_NEAREST = 0,
    SRCNN_TPU_F_BILINEAR,
    SRCNN_TPU_F_BICUBIC,
    SRCNN_TPU_F_LANCZOS3,
    SRCNN_TPU_F_BSPLINE
} SRCNNTpuFilterType;

/* Reference version-parity constant (`libsrcnn.h:35`): 0x00010A28. */
unsigned SRCNN_Version(void);

/* Release a buffer returned by ProcessSRCNN. NULL is a no-op. */
void SRCNN_FreeBuffer(unsigned char* p);

/* Set the process-global interpolation filter and step-scale mode used
 * by ProcessSRCNN (`libsrcnn.h:46-47`). Thread-safe (unlike the
 * reference). Errors (bad enum via Python-side validation) print to
 * stderr; the call is void like the reference's. */
void ConfigureFilterSRCNN(int ftype, int stepscale);

/* Super-resolve an interleaved u8 RGB(A) buffer (`libsrcnn.h:48-54`).
 *
 *   refbuff            w*h*d bytes, d = 3 (RGB) or 4 (RGBA)
 *   multiply           scale factor (> 0; fractional allowed)
 *   outbuff/outbuffsz  required: receives the malloc()'d result,
 *                      ceil-truncated to (w*multiply) x (h*multiply) x d
 *   convbuff/convbuffsz optional (NULL to skip): the u8 Y-channel
 *                      convolution map, as the reference's optional
 *                      4th/5th arguments (`libsrcnn.cpp:889-915`)
 *
 * Returns 0 on success; reference-parity error codes otherwise:
 *   -1 bad args, -2 bad scale, -11/-12 allocation failure,
 *   -100 internal failure (details on stderr). */
int ProcessSRCNN(const unsigned char* refbuff,
                 unsigned w, unsigned h, unsigned d,
                 float multiply,
                 unsigned char** outbuff, unsigned* outbuffsz,
                 unsigned char** convbuff, unsigned* convbuffsz);

#ifdef __cplusplus
}
#endif

#endif /* LIBSRCNN_TPU_C_H */
