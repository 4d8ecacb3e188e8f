"""Bytes and decode time of a pixels traffic mix's pictures against
photographs, on the machine it runs on. The benchmark's runs never run it.

    python3 portbench/jpeg_cost.py --photos <dir of JPEG photographs> \
        [--traffic q2a_pixels_b16] [--seed 1] [--sample 60] [--repeats 9]

Each photograph is decoded and coded again at the mix's JPEG quality, so
that both sides carry the same quantisation. Then, for the photographs,
for pictures of the generator at each photograph's size, and for a
sample of the mix's own pictures at their sizes: bits a pixel, bytes a
picture and milliseconds a decode (the median of ``repeats`` decodes in
one thread, read as the port's loader reads an image: PIL, RGB, numpy).
Prints one JSON object.
"""

import argparse
import io
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def decode_ms(data, repeats):
    import numpy as np
    from PIL import Image

    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        with Image.open(io.BytesIO(data)) as img:
            np.asarray(img.convert("RGB"), np.uint8)
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e3


def reading(data, w, h, repeats):
    return {"w": w, "h": h, "bytes": len(data),
            "bits_per_pixel": len(data) * 8 / (w * h),
            "decode_ms": decode_ms(data, repeats),
            "decode_ms_per_mpixel": decode_ms(data, repeats) / (w * h / 1e6)}


def summary(rows):
    keys = ("bytes", "bits_per_pixel", "decode_ms", "decode_ms_per_mpixel")
    return {k: [min(r[k] for r in rows), statistics.median(r[k] for r in rows),
                max(r[k] for r in rows)] for k in keys}


def main(argv=None):
    import numpy as np
    from PIL import Image

    from portbench import harness
    from portbench.generators import common

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--photos", required=True)
    p.add_argument("--traffic", default="q2a_pixels_b16")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--sample", type=int, default=60)
    p.add_argument("--repeats", type=int, default=9)
    args = p.parse_args(argv)
    mix = harness._json(harness.BENCH_DIR / "traffic" / f"{args.traffic}.json")
    gen = harness.load(mix["generator"])
    d = mix["data"]
    r = common.rng(args.seed, 1)
    bank = gen.texture_bank(r, d["texture"])
    out = {"traffic": args.traffic, "quality": d["jpeg_quality"],
           "photos": {}, "generated_at_photo_size": {}}
    for name in sorted(os.listdir(args.photos)):
        if not name.lower().endswith((".jpg", ".jpeg")):
            continue
        with Image.open(os.path.join(args.photos, name)) as img:
            px = np.asarray(img.convert("RGB"), np.uint8)
        h, w = px.shape[:2]
        out["photos"][name] = reading(gen.jpeg(px, d["jpeg_quality"]), w, h,
                                      args.repeats)
        rows = [reading(gen.jpeg(gen.picture(r, bank, w, h, d["texture"]),
                                 d["jpeg_quality"]), w, h, args.repeats)
                for _ in range(5)]
        out["generated_at_photo_size"][name] = summary(rows)
    rows = []
    for _ in range(args.sample):
        w = int(r.integers(d["width"][0], d["width"][1] + 1))
        h = int(round(w / r.uniform(*d["aspect"])))
        rows.append(reading(gen.jpeg(gen.picture(r, bank, w, h,
                                                 d["texture"]),
                                     d["jpeg_quality"]), w, h, args.repeats))
    out["traffic_pictures"] = summary(rows)
    out["summary_keys"] = "[min, median, max]"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
