/* C client of the libsrcnn_tpu C ABI — the reference's two-function
 * library surface (`libsrcnn.h:46-54`) served by the JAX framework.
 *
 * Build + run (from the repo root):
 *   make -C native capi
 *   gcc -O2 -o /tmp/c_client examples/07_c_client.c \
 *       -Lnative -lsrcnn_tpu_c -Wl,-rpath,$PWD/native
 *   PYTHONPATH=$PWD JAX_PLATFORMS=cpu /tmp/c_client          # host CPU
 *   PYTHONPATH=$PWD /tmp/c_client                   # JAX's default device
 */
#include <stdio.h>
#include <stdlib.h>

#include "../native/libsrcnn_tpu_c.h"

int main(void) {
    enum { W = 64, H = 48, D = 3 };
    unsigned char* rgb = malloc((size_t)W * H * D);
    for (int i = 0; i < W * H * D; ++i) rgb[i] = (unsigned char)(i * 131 % 256);

    printf("libsrcnn version parity constant: 0x%08X\n", SRCNN_Version());
    ConfigureFilterSRCNN(SRCNN_TPU_F_BICUBIC, /*stepscale=*/0);

    unsigned char *out = NULL, *conv = NULL;
    unsigned outsz = 0, convsz = 0;
    int rc = ProcessSRCNN(rgb, W, H, D, 2.0f, &out, &outsz, &conv, &convsz);
    if (rc != 0) {
        fprintf(stderr, "ProcessSRCNN failed: %d\n", rc);
        return 1;
    }
    printf("ok: %ux%u RGB -> %u bytes out, %u bytes Y-conv map\n",
           W, H, outsz, convsz);

    SRCNN_FreeBuffer(out);
    SRCNN_FreeBuffer(conv);
    free(rgb);
    return 0;
}
