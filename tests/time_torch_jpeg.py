"""Host seconds of the port's JPEG decode on one ScanNet-size frame in each
of its kinds.

    python tests/time_torch_jpeg.py

A 968x1296 colour frame (the textured noise of ``test_torch_jpeg.py``) is
written by PIL at quality 90, baseline and progressive (``progressive=
True``, PIL's default scan script: ten scans); the baseline file is
transcoded to arithmetic coding, sequential and progressive (PIL's script;
``jpeg_writers.transcode_arith``), and the progressive one is cut after
six of its ten scans, so that libjpeg block-smooths it. Each file is
checked against PIL's pixels, or, where PIL refuses it (an arithmetic file
longer than PIL's 65536-byte read block), against cv2's with the port's
PIL route refusing it too; then it is decoded by ``io/jpeg.decode_jpeg``
three times on the CPU (numpy and Python entropy loops). The best of three
and the median are printed with the CPU's name.
"""

import io
import os
import platform
import statistics
import sys
import time

import cv2
import numpy as np
from PIL import Image

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]

import jpeg_writers  # noqa: E402
from maskclustering_tpu_torch.io import jpeg  # noqa: E402


def _frame(h=968, w=1296, seed=5):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // (w - 1), y * 255 // (h - 1), (x + 2 * y) * 3 % 256], axis=-1)
    return np.clip(base + rng.normal(0.0, 20.0, (h, w, 3)), 0, 255).astype(np.uint8)


def _cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown CPU"


def main() -> int:
    img = _frame()
    files = {}
    for kind, kw in (("baseline", {}), ("progressive", {"progressive": True})):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=90, **kw)
        files[kind] = buf.getvalue()
    t0 = time.perf_counter()
    files["arithmetic sequential"] = jpeg_writers.transcode_arith(files["baseline"])
    files["arithmetic progressive"] = jpeg_writers.transcode_arith(files["baseline"],
                                                                   progressive=True)
    files["progressive cut after 6 of 10 scans (smoothed)"] = jpeg_writers.cut_after(
        files["progressive"], 6)
    made = time.perf_counter() - t0
    print(f"968x1296 q90 on {_cpu_name()} ({os.cpu_count()} cores); the two arithmetic "
          f"transcodes written in {made:.1f} s")
    for kind, data in files.items():
        try:
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            against = "PIL"
        except OSError:
            try:
                jpeg.decode_jpeg(data, reader="pil")
                raise SystemExit(f"the PIL route reads the {kind} file that PIL refuses")
            except NotImplementedError:
                pass
            want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1]
            against = "cv2; PIL and the port's PIL route refuse it"
        if not np.array_equal(jpeg.decode_jpeg(data), want):
            raise SystemExit(f"the {kind} decode differs from {against}'s")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            jpeg.decode_jpeg(data)
            times.append(time.perf_counter() - t0)
        print(f"{kind}: {len(data)} bytes, decode best {min(times):.3f} s, median "
              f"{statistics.median(times):.3f} s (== {against})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
