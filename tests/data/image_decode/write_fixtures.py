"""Writes the JPEG fixtures of chip_smoke.py's pinned digests
(``WO_DIGESTS``) with cv2 5.0.0's ``imwrite``: the machine with the card
has no OpenCV, so these files travel with the repository. Run from the
repository's root: ``python tests/data/image_decode/write_fixtures.py``.
The same seed writes the same files."""
import struct
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent


def scene(h, w, seed):
    """Smooth colour gradients with a few sharp-edged discs and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 / max(w - 1, 1)), (yy * 255 / max(h - 1, 1)),
                    ((xx + yy) * 127 / max(h + w - 2, 1))], -1)
    for _ in range(5):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, 15)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 6, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def exif_app1(orientation):
    """An APP1 segment of one IFD0 entry: the EXIF orientation."""
    tiff = (b"MM\x00*" + struct.pack(">I", 8) + struct.pack(">H", 1)
            + struct.pack(">HHIH", 0x112, 3, 1, orientation) + b"\0\0"
            + struct.pack(">I", 0))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def main():
    colour = scene(61, 83, 17)
    q = cv2.IMWRITE_JPEG_QUALITY
    sf = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    files = {
        "grey": (cv2.cvtColor(colour, cv2.COLOR_BGR2GRAY), [q, 85]),
        "colour_420": (colour, [q, 90, sf,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]),
        "colour_422": (colour, [q, 75, sf,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
        "progressive": (colour, [q, 95, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
        "restart_7": (colour, [q, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 7]),
    }
    for name, (img, params) in files.items():
        ok, enc = cv2.imencode(".jpg", img, params)
        assert ok
        (HERE / f"{name}.jpg").write_bytes(enc.tobytes())
    ok, enc = cv2.imencode(".jpg", colour, [q, 90])
    data = enc.tobytes()
    (HERE / "exif_orientation_6.jpg").write_bytes(data[:2] + exif_app1(6)
                                                  + data[2:])


if __name__ == "__main__":
    main()
