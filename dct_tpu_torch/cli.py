"""Command-line interface of the PyTorch/CUDA port: encode / decode /
inspect / bench, on the card.

The subcommands, flags, exit codes, printed lines and file formats are
the reference package's (``python -m dct_tpu.cli``), so its command lines
run unchanged, and each CLI reads the files the other writes. One flag
more: ``--device`` on every subcommand that runs the codec (default
``cuda``: the card, and an error where there is none; ``--device cpu``
runs the kernels' plain versions). ``info`` and ``verify`` read
containers on the host and take no device. ``--pallas`` is accepted and
ignored, as the port's CodecConfig ignores ``use_pallas``.

  python -m dct_tpu_torch.cli encode input.pgm out.tpdc --quality 75 --adaptive
  python -m dct_tpu_torch.cli decode out.tpdc recon.pgm
  python -m dct_tpu_torch.cli info out.tpdc
  python -m dct_tpu_torch.cli bench --size 1920x1088 --frames 8
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda, the card; "
                        "'cpu' runs the kernels' plain versions)")


def _add_codec_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--quality", type=int, default=50, help="1-100 (JPEG-style)")
    p.add_argument("--block-size", type=int, default=8)
    p.add_argument("--adaptive", action="store_true",
                   help="per-block variance-adaptive quantization")
    p.add_argument("--huffman", choices=("category", "direct", "none"),
                   default="category")
    p.add_argument("--static-tables", action="store_true",
                   help="fixed default Huffman table (single-pass encode)")
    p.add_argument("--coded-runs", action="store_true",
                   help="Huffman-code run lengths (~40%% smaller files than "
                        "the reference's fixed 8-bit run field)")
    p.add_argument("--dc-prediction", action="store_true",
                   help="delta-code DC coefficients within each stripe "
                        "(smaller files; the reference codes DCs raw)")
    p.add_argument("--stripe-rows", type=int, default=1,
                   help="block rows per bitstream stripe")
    p.add_argument("--chroma", choices=("gray", "444", "420"), default=None,
                   help="color mode (default: gray for 2D input, 420 for RGB)")
    p.add_argument("--pallas", action="store_true",
                   help="accepted for the reference CLI's command lines; "
                        "ignored (the port runs its kernels on the card)")
    p.add_argument("--decode-index", default="auto",
                   choices=("auto", "on", "off"),
                   help="store bit-packed per-block bit lengths "
                        "(container v2) so decode's entropy stage can "
                        "run on the card; 'auto' (default) includes the "
                        "index only when it costs <= 6%% of the payload")
    p.add_argument("--compat-b1", action="store_true",
                   help="reproduce reference dequant bug B1")
    _add_device_arg(p)


def _config_from_args(args, color: bool):
    from dct_tpu_torch.config import CodecConfig

    chroma = args.chroma or ("420" if color else "gray")
    return CodecConfig(
        block_size=args.block_size,
        quality=args.quality,
        adaptive=args.adaptive,
        use_huffman=args.huffman != "none",
        huffman_mode=args.huffman,
        static_tables=args.static_tables,
        coded_runs=args.coded_runs,
        dc_prediction=args.dc_prediction,
        stripe_rows=args.stripe_rows,
        chroma=chroma,
        use_pallas=args.pallas,
        decode_index={"auto": "auto", "on": True, "off": False}[
            args.decode_index
        ],
        compat_b1=args.compat_b1,
    )


def _device(args):
    """The ``device=`` for the entry points: None for ``cuda``, so that
    they take the card and raise "no CUDA device" where there is none
    (they never carry on on the CPU); any other device as given."""
    return None if args.device == "cuda" else args.device


def cmd_encode(args) -> int:
    from dct_tpu_torch.models import codec
    from dct_tpu_torch.utils import image_io, metrics

    img = image_io.read_image(args.input)
    cfg = _config_from_args(args, color=img.ndim == 3)
    dev = _device(args)
    t0 = time.perf_counter()
    if args.max_bytes is not None and args.min_psnr is not None:
        print("encode: --max-bytes and --min-psnr are mutually exclusive",
              file=sys.stderr)
        return 2
    try:
        if args.max_bytes is not None:
            from dct_tpu_torch.models import rate_control

            data, q = rate_control.encode_to_size(img, args.max_bytes, cfg,
                                                  device=dev)
            chosen = f" (rate control: quality {q} for <= {args.max_bytes} B)"
        elif args.min_psnr is not None:
            from dct_tpu_torch.models import rate_control

            data, q = rate_control.encode_to_psnr(img, args.min_psnr, cfg,
                                                  device=dev)
            chosen = f" (rate control: quality {q} for >= {args.min_psnr} dB)"
        else:
            data = codec.encode(img, cfg, dev)
            chosen = ""
    except ValueError as e:
        # infeasible rate-control target: clean message, not a traceback
        print(f"encode: {e}", file=sys.stderr)
        return 2
    dt = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        f.write(data)
    raw = img.size
    print(
        f"{args.input}: {img.shape[1]}x{img.shape[0]}"
        f"{'x3' if img.ndim == 3 else ''} -> {len(data)} bytes "
        f"({metrics.compression_ratio(raw, len(data)):.2f}:1) in {dt*1e3:.1f} ms"
        f"{chosen}"
    )
    return 0


def cmd_decode(args) -> int:
    from dct_tpu_torch.models import codec
    from dct_tpu_torch.utils import image_io

    data = open(args.input, "rb").read()
    try:
        img = codec.decode(data, _device(args))
    except ValueError as e:
        # corrupt/hostile container: clean message (run `verify` for the
        # per-stripe report), not a traceback
        print(f"decode: {args.input}: {e}", file=sys.stderr)
        return 1
    image_io.write_image(args.output, img)
    print(f"{args.input} -> {args.output} ({img.shape[1]}x{img.shape[0]})")
    return 0


def cmd_info(args) -> int:
    from dct_tpu_torch import container as cont

    data = open(args.input, "rb").read()
    if data[:4] == cont.VIDEO_MAGIC:  # .tpdv: stream summary + frame 0
        streams = cont.deserialize_streams(data)
        if not streams:
            print(json.dumps({"stream_file": True, "frames": 0}))
            return 0
        c0 = cont.deserialize(streams[0])
        info = {
            "stream_file": True,
            "frames": len(streams),
            "total_bytes": len(data),
            "frame_bytes": [len(s) for s in streams],
            "width": c0.width,
            "height": c0.height,
            "quality": c0.config.quality,
            "chroma": c0.config.chroma,
        }
        print(json.dumps(info, indent=2))
        return 0
    c = cont.deserialize(data)
    cfg = c.config
    info = {
        "stream_file": False,
        "width": c.width,
        "height": c.height,
        "block_size": cfg.block_size,
        "quality": cfg.quality,
        "adaptive": cfg.adaptive,
        "huffman_mode": cfg.huffman_mode if cfg.use_huffman else "none",
        "static_tables": cfg.static_tables,
        "coded_runs": cfg.coded_runs,
        "dc_prediction": cfg.dc_prediction,
        "chroma": cfg.chroma,
        "stripe_rows": cfg.stripe_rows,
        "decode_index": cfg.decode_index,
        "planes": [
            {
                "width": p.width,
                "height": p.height,
                "stripes": len(p.stripes),
                "payload_bytes": int(sum(len(s) for s in p.stripes)),
            }
            for p in c.planes
        ],
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_roundtrip(args) -> int:
    from dct_tpu_torch.models import codec
    from dct_tpu_torch.utils import image_io, metrics

    img = image_io.read_image(args.input)
    cfg = _config_from_args(args, color=img.ndim == 3)
    dev = _device(args)
    data = codec.encode(img, cfg, dev)
    rec = codec.decode(data, dev)
    print(
        f"PSNR {metrics.psnr(rec, img):.2f} dB, "
        f"{metrics.compression_ratio(img.size, len(data)):.2f}:1 "
        f"({len(data)} bytes)"
    )
    return 0


def _verify_frames(streams: list[bytes]) -> dict:
    """{frame: its corrupt stripes, or "unreadable"} of a .tpdv's frames."""
    from dct_tpu_torch.models import recovery

    bad = {}
    for i, s in enumerate(streams):
        try:
            b = recovery.verify(s)
        except (ValueError, IndexError):
            # header/table damage: the frame cannot even be parsed
            b = "unreadable"
        if b:
            bad[i] = b
    return bad


def cmd_verify(args) -> int:
    from dct_tpu_torch import container as cont
    from dct_tpu_torch.models import recovery

    data = open(args.input, "rb").read()
    if data[:4] == cont.VIDEO_MAGIC:  # .tpdv: scan every frame
        bad = _verify_frames(cont.deserialize_streams(data))
        if bad:
            print(f"{args.input}: CORRUPT frames {bad}")
            return 1
        print(f"{args.input}: all frames OK")
        return 0
    bad = recovery.verify(data)
    if bad:
        print(f"{args.input}: CORRUPT stripes {bad}")
        return 1
    print(f"{args.input}: all stripes OK")
    return 0


def cmd_repair(args) -> int:
    from dct_tpu_torch import container as cont
    from dct_tpu_torch.models import recovery
    from dct_tpu_torch.utils import image_io

    data = open(args.input, "rb").read()
    out = args.output or args.input
    dev = _device(args)
    if data[:4] == cont.VIDEO_MAGIC:  # .tpdv: repair frame by frame
        src = np.load(args.source)  # u8 (F, H, W[, 3]) source stack
        streams = cont.deserialize_streams(data)
        if len(src) != len(streams):
            raise SystemExit(
                f"source has {len(src)} frames, stream file {len(streams)}"
            )
        bad = _verify_frames(streams)
        if not bad:
            print(f"{args.input}: nothing to repair")
            return 0
        template = next(
            (streams[i] for i in range(len(streams)) if i not in bad), None
        )
        for i, b in bad.items():
            if b == "unreadable":
                # frame header/tables destroyed: rebuild every stripe
                # against a readable sibling's tables (batch frames share
                # them, so the result matches the lost original)
                if template is None:
                    raise SystemExit(
                        f"{args.input}: no intact frame to take tables from"
                    )
                streams[i] = recovery.rebuild(template, src[i], device=dev)
            else:
                streams[i] = recovery.repair(streams[i], src[i], stripes=b,
                                             device=dev)
        with open(out, "wb") as f:
            f.write(cont.serialize_streams(streams))
        print(f"{args.input}: re-encoded frames {bad} -> {out}")
        return 0
    src = image_io.read_image(args.source)
    bad = recovery.verify(data)
    if not bad:
        print(f"{args.input}: nothing to repair")
        return 0
    fixed = recovery.repair(data, src, stripes=bad, device=dev)
    with open(out, "wb") as f:
        f.write(fixed)
    print(f"{args.input}: re-encoded stripes {bad} -> {out}")
    return 0


def cmd_bench(args) -> int:
    import torch

    from dct_tpu_torch.models import codec
    from dct_tpu_torch.utils import image_io, metrics

    w, h = (int(x) for x in args.size.split("x"))
    cfg = _config_from_args(args, color=False).replace(static_tables=True)
    dev = _device(args)
    dev = codec._default_device() if dev is None else torch.device(dev)
    frames = np.stack(
        [image_io.synthetic_image(h, w, "photo", seed=s) for s in range(args.frames)]
    )
    n_stripes = codec._padded_grid(h, w, cfg)[2]
    padded = codec.pad_plane_for_encode(torch.from_numpy(frames).to(dev), cfg)
    tp = metrics.measure_throughput(codec.encode_step, padded, cfg, n_stripes,
                                    iters=args.iters, pixels=frames.size)
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    print(f"{tp.mpix_per_s:.1f} Mpix/s ({tp.seconds_per_frame*1e3:.2f} ms / "
          f"{args.frames} frames of {w}x{h}, {clock})")
    return 0


def cmd_encode_video(args) -> int:
    from dct_tpu_torch import container as cont
    from dct_tpu_torch.models.video import VideoCodec
    from dct_tpu_torch.utils import metrics

    frames = np.load(args.input)
    if frames.dtype != np.uint8 or frames.ndim not in (3, 4):
        raise SystemExit(
            f"expected u8 (F, H, W) or (F, H, W, 3) .npy, got "
            f"{frames.dtype} {frames.shape}"
        )
    color = frames.ndim == 4
    cfg = _config_from_args(args, color=color)
    dev = _device(args)
    t0 = time.perf_counter()
    chosen = ""
    if args.max_total_bytes is not None:
        from dct_tpu_torch.models import rate_control

        # budget the per-frame containers; the .tpdv wrapper adds a known
        # 8 + 4F bytes on top (container.serialize_streams)
        wrapper = 8 + 4 * frames.shape[0]
        if args.max_total_bytes <= wrapper:
            print(
                f"encode-video: --max-total-bytes {args.max_total_bytes} "
                f"cannot even cover the {wrapper}-byte .tpdv stream header "
                f"for {frames.shape[0]} frames", file=sys.stderr,
            )
            return 2
        try:
            streams, q = rate_control.encode_video_to_size(
                frames, args.max_total_bytes - wrapper, cfg,
                chunk_frames=args.chunk_frames, device=dev,
            )
        except ValueError as e:
            print(f"encode-video: {e}", file=sys.stderr)
            return 2
        chosen = f" (rate control: quality {q})"
    else:
        streams = VideoCodec(cfg, chunk_frames=args.chunk_frames,
                             device=dev).encode(frames)
    dt = time.perf_counter() - t0
    data = cont.serialize_streams(streams)
    with open(args.output, "wb") as f:
        f.write(data)
    print(
        f"{args.input}: {frames.shape[0]} frames -> {len(data)} bytes "
        f"({metrics.compression_ratio(frames.size, len(data)):.2f}:1) "
        f"in {dt*1e3:.1f} ms{chosen}"
    )
    return 0


def cmd_decode_video(args) -> int:
    from dct_tpu_torch import container as cont
    from dct_tpu_torch.models.video import VideoCodec

    streams = cont.deserialize_streams(open(args.input, "rb").read())
    if not streams:
        raise SystemExit(f"{args.input}: stream file contains no frames")
    cfg = cont.deserialize(streams[0]).config
    frames = VideoCodec(cfg, device=_device(args)).decode(streams)
    np.save(args.output, frames)
    print(f"{args.input} -> {args.output} ({frames.shape})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dct-tpu-torch",
        description="DCT image codec on a CUDA card (the PyTorch port of "
                    "dct-tpu)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("encode", help="image -> .tpdc")
    p.add_argument("input"); p.add_argument("output")
    _add_codec_args(p)
    p.add_argument("--max-bytes", type=int, default=None,
                   help="encode to a byte budget: pick the highest quality "
                        "whose EXACT container size fits (--quality is "
                        "ignored; models/rate_control.py)")
    p.add_argument("--min-psnr", type=float, default=None,
                   help="encode to a distortion target: pick the lowest "
                        "quality whose EXACT PSNR meets this many dB "
                        "(--quality is ignored)")
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("decode", help=".tpdc -> image")
    p.add_argument("input"); p.add_argument("output")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("info", help="inspect a .tpdc container")
    p.add_argument("input")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("roundtrip", help="encode+decode, report PSNR/ratio")
    p.add_argument("input")
    _add_codec_args(p)
    p.set_defaults(fn=cmd_roundtrip)

    p = sub.add_parser("verify", help="per-stripe integrity scan of a .tpdc")
    p.add_argument("input")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser(
        "repair", help="re-encode corrupt stripes from the source image"
    )
    p.add_argument("input"); p.add_argument("source")
    p.add_argument("-o", "--output", default=None,
                   help="write here instead of in place")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_repair)

    p = sub.add_parser(
        "encode-video", help="u8 (F,H,W[,3]) .npy -> .tpdv stream file"
    )
    p.add_argument("input"); p.add_argument("output")
    p.add_argument("--chunk-frames", type=int, default=None,
                   help="frames per device dispatch (default: auto "
                        "from the 128 Mpix memory budget)")
    _add_codec_args(p)
    p.add_argument("--max-total-bytes", type=int, default=None,
                   help="encode the whole .tpdv to a byte budget: one "
                        "shared quality, exact size probes (--quality "
                        "is ignored)")
    p.set_defaults(fn=cmd_encode_video)

    p = sub.add_parser("decode-video", help=".tpdv -> u8 .npy frame stack")
    p.add_argument("input"); p.add_argument("output")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_decode_video)

    p = sub.add_parser("bench", help="encode throughput")
    p.add_argument("--size", default="1920x1088")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--iters", type=int, default=10)
    _add_codec_args(p)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
