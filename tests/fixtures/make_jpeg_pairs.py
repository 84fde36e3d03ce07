"""Write ``jpeg_pairs.tar``: 16 webdataset-style (JPEG, caption) pairs.

Each image is 64 x 48 (width x height), one of the 16 colour classes of the
real-data convergence oracle with a smooth sinusoid texture on it, saved by
PIL at quality 90; its caption names the colour (``a red square``). The
members are ``pair-NN.jpg`` + ``pair-NN.txt``. A machine without PIL cannot
encode a JPEG, so this committed file is how it gets JPEG bytes: the native
decoder's check on the card and the CPU tests read it.

Run from the repository root to regenerate (the output is deterministic for
a given PIL / libjpeg):

    python tests/fixtures/make_jpeg_pairs.py
"""

import io
import os
import tarfile

import numpy as np
from PIL import Image

NAMES = ["red", "green", "blue", "cyan", "magenta", "yellow", "white", "gray",
         "crimson", "lime", "navy", "teal", "purple", "olive", "silver", "black"]
COLORS = [(220, 30, 30), (30, 200, 30), (30, 30, 220), (30, 200, 200),
          (200, 30, 200), (220, 220, 30), (240, 240, 240), (128, 128, 128),
          (150, 20, 60), (120, 255, 60), (20, 20, 120), (20, 120, 120),
          (120, 20, 160), (120, 120, 30), (190, 190, 190), (15, 15, 15)]
WIDTH, HEIGHT, QUALITY, SEED = 64, 48, 90, 16
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg_pairs.tar")


def main() -> None:
    rng = np.random.default_rng(SEED)
    yy = np.linspace(0.0, 1.0, HEIGHT)[:, None, None]
    xx = np.linspace(0.0, 1.0, WIDTH)[None, :, None]
    with tarfile.open(OUT, "w", format=tarfile.USTAR_FORMAT) as tf:
        for i, (name, color) in enumerate(zip(NAMES, COLORS)):
            f, ph = rng.uniform(1.0, 3.0, (2, 3)), rng.uniform(0.0, 6.28, (2, 3))
            texture = 12.0 * (np.sin(6.28 * f[0] * yy + ph[0]) + np.sin(6.28 * f[1] * xx + ph[1]))
            arr = np.clip(np.asarray(color, np.float64) + texture, 0, 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, "JPEG", quality=QUALITY)
            for member, blob in ((f"pair-{i:02d}.jpg", buf.getvalue()),
                                 (f"pair-{i:02d}.txt", f"a {name} square".encode())):
                info = tarfile.TarInfo(member)
                info.size = len(blob)
                tf.addfile(info, io.BytesIO(blob))
    print(f"{OUT}: {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
