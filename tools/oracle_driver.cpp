// Minimal raw-buffer driver for the REFERENCE library (test oracle only).
//
// Links against the reference's public 2-function C API (libsrcnn.h:46-54)
// to generate golden outputs for the JAX framework's regression tests --
// this avoids the FLTK dependency of the reference's own test app.
//
// Usage:
//   oracle_driver <in.raw> <w> <h> <d> <multiply> <filter 0-4> <step 0|1>
//                 <out.raw> <conv.raw>
//
// in.raw is w*h*d interleaved u8; outputs are raw u8 buffers.
// Prints "OK <outsize> <convsize> <ms>" on success.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <sys/time.h>
#include "libsrcnn.h"

static double now_ms() {
    struct timeval tv;
    gettimeofday(&tv, nullptr);
    return tv.tv_sec * 1000.0 + tv.tv_usec / 1000.0;
}

int main(int argc, char** argv) {
    if (argc < 10) {
        fprintf(stderr, "usage: %s in.raw w h d multiply filter step out.raw conv.raw\n", argv[0]);
        return 2;
    }
    const char* inpath = argv[1];
    unsigned w = atoi(argv[2]), h = atoi(argv[3]), d = atoi(argv[4]);
    float multiply = atof(argv[5]);
    int filter = atoi(argv[6]);
    int step = atoi(argv[7]);
    const char* outpath = argv[8];
    const char* convpath = argv[9];

    size_t insz = (size_t)w * h * d;
    unsigned char* inbuf = new unsigned char[insz];
    FILE* f = fopen(inpath, "rb");
    if (!f || fread(inbuf, 1, insz, f) != insz) {
        fprintf(stderr, "bad input file\n");
        return 3;
    }
    fclose(f);

    ConfigureFilterSRCNN((SRCNNFilterType)filter, step != 0);

    unsigned char* outbuf = nullptr;
    unsigned outsz = 0;
    unsigned char* convbuf = nullptr;
    unsigned convsz = 0;

    double t0 = now_ms();
    int rc = ProcessSRCNN(inbuf, w, h, d, multiply, outbuf, outsz, &convbuf, &convsz);
    double t1 = now_ms();
    if (rc != 0) {
        fprintf(stderr, "ProcessSRCNN rc=%d\n", rc);
        return 4;
    }

    f = fopen(outpath, "wb");
    fwrite(outbuf, 1, outsz, f);
    fclose(f);
    f = fopen(convpath, "wb");
    if (convbuf) fwrite(convbuf, 1, convsz, f);
    fclose(f);

    printf("OK %u %u %.1f\n", outsz, convsz, t1 - t0);
    return 0;
}
