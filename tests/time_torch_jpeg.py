"""Host seconds of the port's JPEG decode: a progressive file beside a
baseline one of the same frame.

    python tests/time_torch_jpeg.py

A ScanNet-size colour frame (968x1296, the textured noise of
``test_torch_jpeg.py``) is written by PIL at quality 90, baseline and
progressive (``progressive=True``, PIL's default scan script: ten scans),
and each is decoded by ``io/jpeg.decode_jpeg`` three times on the CPU
(numpy and a Python Huffman loop); the best of three and the median are
printed with the CPU's name. Both decodes are checked against PIL's
pixels first.
"""

import io
import os
import platform
import statistics
import sys
import time

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

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
    print(f"968x1296 q90 on {_cpu_name()} ({os.cpu_count()} cores)")
    for kind, data in files.items():
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        if not np.array_equal(jpeg.decode_jpeg(data), want):
            raise SystemExit(f"the {kind} decode differs from PIL's")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            jpeg.decode_jpeg(data)
            times.append(time.perf_counter() - t0)
        print(f"{kind}: {len(data)} bytes, decode best {min(times):.3f} s, median "
              f"{statistics.median(times):.3f} s (== PIL)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
