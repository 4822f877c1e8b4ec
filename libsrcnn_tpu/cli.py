"""Command-line interface, flag-compatible with the reference test app.

The reference CLI (`test.cpp:290-448,513-531`):

    srcnntest <input> [output] --scale=F --filter=N --step [--waitakey]

* ``--scale=F``  float multiply factor (default 2.0, `test.cpp:30`)
* ``--filter=N`` 0 nearest / 1 bilinear / 2 bicubic (default) / 3 lanczos3
  / 4 b-spline (`test.cpp:341-365`)
* ``--step``     enable step-scaling
* output auto-naming: ``<input>_resized.png`` and ``<input>_convolution.png``
  (`test.cpp:387-445`)

Extras: ``--filter`` also accepts names, ``--pallas`` / ``--no-pallas``
force the fused srcnn kernel on or off (default: auto), ``--model=fsrcnn`` selects the
FSRCNN family (learned-deconv upscale, integer scale), ``--debug-dir=DIR``
dumps intermediate planes like the reference's DEBUG builds, ``--repeat=N``
for quick timing loops.

Run as ``python -m libsrcnn_tpu.cli`` or the ``srcnn-tpu`` entry point.
"""

from __future__ import annotations

import os
import sys

from .config import FilterType, SRCNNConfig

_FILTER_NAMES = {
    "nearest": FilterType.NEAREST,
    "bilinear": FilterType.BILINEAR,
    "bicubic": FilterType.BICUBIC,
    "lanczos3": FilterType.LANCZOS3,
    "bspline": FilterType.BSPLINE,
}


def _auto_name(src: str, suffix: str) -> str:
    # `test.cpp:387-445`: swap extension for `<stem>_<suffix>.png`.
    # splitext, not rpartition: a dot in a DIRECTORY component
    # ("photos.2024/cat") must not truncate the path.
    import os

    stem, _ext = os.path.splitext(src)
    return f"{stem or src}_{suffix}.png"


def parse_args(argv: list[str]):
    scale = 2.0
    filter_type = FilterType.BICUBIC
    step = False
    ensemble = False
    use_pallas = None  # auto: pipeline.resolve_pallas
    model = "srcnn"
    dtype = "float32"
    repeat = 1
    debug_dir = None
    chunked_rows = 0   # 0 = one-shot pipeline; N = out-of-core bands
    file_src = None
    file_dst = None

    for arg in argv:
        if arg.startswith("--scale="):
            try:
                v = float(arg[8:] or 0)
            except ValueError:
                v = 0.0  # reference parity: atof("abc") == 0 (`test.cpp`)
            if v > 0:
                scale = v
        elif arg.startswith("--filter="):
            v = arg[9:]
            if v.lower() in _FILTER_NAMES:
                filter_type = _FILTER_NAMES[v.lower()]
            else:
                try:
                    filter_type = FilterType(int(v))
                except ValueError:
                    filter_type = FilterType.BICUBIC  # `test.cpp:353` default
        elif arg.startswith("--step"):
            step = True
        elif arg == "--ensemble":
            ensemble = True  # flip self-ensemble: 4x compute, free quality
        elif arg == "--no-pallas":
            use_pallas = False
        elif arg.startswith("--pallas"):
            use_pallas = True
        elif arg.startswith("--model="):
            model = arg[8:]
            if model not in ("srcnn", "fsrcnn", "espcn", "vdsr", "srcnn955"):
                raise SystemExit(f"unknown model: {model}")
        elif arg == "--bf16":
            dtype = "bfloat16"  # throughput mode (~1.5x, SSIM>=0.999)
        elif arg == "--bf16-fast":
            dtype = "bfloat16_fast"  # fastest bf16 tier (1-pass GEMMs)
        elif arg == "--int8":
            dtype = "int8"      # draft tier (fastest, ~40 dB vs exact)
        elif arg.startswith("--repeat="):
            try:
                repeat = max(1, int(arg[9:]))
            except ValueError:
                repeat = 1  # reference parity: atoi-tolerant
        elif arg == "--chunked":
            chunked_rows = 512  # out-of-core default band height
        elif arg.startswith("--chunked="):
            try:
                chunked_rows = max(1, int(arg[10:]))
            except ValueError:
                chunked_rows = 512
        elif arg.startswith("--debug-dir="):
            debug_dir = arg[12:]
        elif arg.startswith("--waitakey"):
            pass  # interactive pause: meaningless in a batch tool, accepted
        elif arg.startswith("--"):
            raise SystemExit(f"unknown option: {arg}")
        elif file_src is None:
            file_src = arg
        elif file_dst is None:
            file_dst = arg

    if file_src is None:
        raise SystemExit(
            "usage: srcnn-tpu <input.(png|jpg|bmp)> [output.png] "
            "--scale=F --filter=0..4|name --step --pallas|--no-pallas "
            "--model=srcnn|fsrcnn|espcn|vdsr|srcnn955 --ensemble --bf16 "
            "--bf16-fast --int8 "
            "--repeat=N "
            "--chunked[=BAND_ROWS] "
            "--debug-dir=DIR"
        )
    if file_dst is None:
        file_dst = _auto_name(file_src, "resized")
    file_conv = _auto_name(file_src, "convolution")

    if chunked_rows and dtype == "int8":
        raise SystemExit("--chunked streams the float32/bfloat16/"
                         "bfloat16_fast tiers; --int8 is one-shot only")
    if chunked_rows and step:
        raise SystemExit("--chunked runs one direct pass; --step's chained "
                         "x2 passes are one-shot only (run per-pass "
                         "--chunked invocations to chain by hand)")
    cfg = SRCNNConfig(filter=filter_type, step_scale=step,
                      use_pallas=use_pallas, compute_dtype=dtype,
                      model=model, self_ensemble=ensemble)
    return (file_src, file_dst, file_conv, scale, cfg, repeat, debug_dir,
            chunked_rows)


def main(argv: list[str] | None = None) -> int:
    (src, dst, convdst, scale, cfg, repeat, debug_dir,
     chunked_rows) = parse_args(sys.argv[1:] if argv is None else argv)
    if debug_dir:
        os.environ["LIBSRCNN_TPU_DEBUG_DIR"] = debug_dir
    if cfg.model == "srcnn" and scale >= 3.0:
        # EVAL.md: the reference 9-1-5 weights are x2-trained and lose to
        # plain bicubic at x3/x4 (-0.30 dB butterfly x4; --step worse)
        print("note: srcnn 9-1-5 underperforms bicubic at x3/x4 -- "
              "consider --model=fsrcnn or --model=espcn (integer scales) "
              "or --model=vdsr/srcnn955", file=sys.stderr)

    # import after arg parsing so `--help`-style errors don't pay JAX init
    from . import api
    from .io import load_image, save_png
    from .utils.tick import get_tick_count

    img = load_image(src)
    print(f"{src}: {img.shape[1]}x{img.shape[0]}x{img.shape[2]}, "
          f"scale={scale}, filter={cfg.filter.name.lower()}, "
          f"step={'on' if cfg.step_scale else 'off'}"
          + (f", model={cfg.model}" if cfg.model != "srcnn" else ""))

    out = conv = None
    t0 = get_tick_count()
    for _ in range(repeat):
        if chunked_rows:
            # out-of-core band streaming: gigapixel stills whose planes
            # exceed device (or host f32) memory; bit-identical to the
            # one-shot path at the same tier (family models: to the
            # direct-conv formulation, lane_pack=False -- see
            # libsrcnn_tpu/chunked.py; band-invariance needs it)
            from .chunked import upscale_chunked

            out, conv = upscale_chunked(img, scale, cfg,
                                        band_rows=chunked_rows)
        else:
            out, conv = api.upscale(img, scale, cfg, return_conv_map=True)
    elapsed = get_tick_count() - t0

    save_png(dst, out)
    if conv is not None:
        # a degenerate step-scale chain emits no conv map (the reference
        # leaves convbuff NULL, `libsrcnn.cpp:1058-1060`)
        save_png(convdst, conv)
    if debug_dir:
        from .utils import debugtool

        written = debugtool.dump_planes(api.debug_intermediates(img, scale, cfg))
        print(f"dumped {len(written)} debug planes to {debug_dir}")

    # matches the reference's completion line (`test.cpp:672`)
    print(f"{dst}: {out.shape[1]}x{out.shape[0]}x{out.shape[2]}")
    if conv is not None:
        print(f"{convdst}: {conv.shape[1]}x{conv.shape[0]}x1")
    print(f"Test Ok, took {elapsed} ms" + (f" ({repeat} runs)" if repeat > 1 else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
