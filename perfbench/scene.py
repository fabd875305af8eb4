"""The traffic generator: a scene of animals in an arena, from a seed.

The scene of the repository's ``bench.py`` (dark elongated animals on a
bright floor, its three channels slightly apart, each animal with its
own slightly asymmetric stamp, moving with jittered velocities and
reflecting at the walls), drawn at any frame size and animal count, and
kept as BGR frames. A traffic file under
``perfbench/traffic/`` holds the parameters: ``width``, ``height``,
``animals``, ``floor_noise`` (the standard deviation, in grey levels,
of a fixed grain on the floor), ``channels`` (3: BGR, the default; 1: a mono camera's
grey frames), ``stamp_scale`` (each stamp enlarged that many times a
side), ``pool`` (distinct frames held in memory) and ``steps_between``
(simulation steps between two pool frames). The sizes are the same for
every seed; the seed moves the animals.
"""
from __future__ import annotations

import numpy as np

FLOOR = (200, 194, 188)  # B, G, R: the channels differ slightly


def stamps(n, scale):
    """`n` stamps (bench.py's: 13-17 by 8-10 pixels, a notch and a
    brighter head breaking the mirror symmetry), `scale` times a side."""
    out = []
    for i in range(n):
        w, h = 13 + i % 5, 8 + i % 3
        st = np.zeros((h, w), np.uint8)
        st[2:h - 2, 1:w - 1] = 90
        st[3:h - 3, 0:w] = 110
        st[2, w - 3:w - 1] = 0
        st[h - 3, 1:3] = 70
        out.append(np.kron(st, np.ones((scale, scale), np.uint8)))
    return out


def make_pool(traffic: dict, seed: int) -> list[np.ndarray]:
    """The pool of distinct (height, width, 3) uint8 BGR frames, or
    (height, width) grey ones."""
    w, h = int(traffic["width"]), int(traffic["height"])
    n = int(traffic["animals"])
    scale = int(traffic.get("stamp_scale", 1))
    every = int(traffic.get("steps_between", 1))
    rng = np.random.default_rng(seed)
    size = np.array([w, h], np.float64)
    margin = np.array([25.0 * scale, 25.0 * scale])
    pos = rng.uniform(30, size - 30 * scale, (n, 2))
    vel = rng.normal(0, 2.0 * scale, (n, 2))
    grey = int(traffic.get("channels", 3)) == 1
    sts = [st if grey else st[..., None] for st in stamps(n, scale)]
    floor = np.array(FLOOR[0] if grey else FLOOR, np.uint8)
    empty = np.empty((h, w) if grey else (h, w, 3), np.uint8)
    empty[:] = floor
    noise = float(traffic.get("floor_noise", 0))
    if noise:
        # a textured floor (grain, sensor noise) shared by every frame
        tex = rng.normal(0, noise, (h, w) if grey else (h, w, 1))
        empty = np.clip(empty + tex, 0, 255).astype(np.uint8)
    frames = []
    for _ in range(int(traffic["pool"])):
        for _ in range(every):
            vel += rng.normal(0, 0.6 * scale, vel.shape)
            np.clip(vel, -4 * scale, 4 * scale, out=vel)
            pos += vel
            over = (pos < 20) | (pos > size - margin)
            vel[over] *= -1
            pos = np.clip(pos, 20, size - margin)
        img = empty.copy()
        for st, (x, y) in zip(sts, pos):
            xi, yi = int(x), int(y)
            region = img[yi:yi + st.shape[0], xi:xi + st.shape[1]]
            np.minimum(region, floor - st[:region.shape[0],
                                          :region.shape[1]], out=region)
        frames.append(img)
    return frames
