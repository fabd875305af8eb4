"""``mfu``: the model operations of every tile completed in the traced
window (``perfbench/flops.py``), over the window, over the card's peak
for the configuration's type, in %."""


def read(t):
    if not t.frames or t.window_s <= 0:
        return None
    work = t.frames * t.tiles_per_frame * t.flops_per_tile
    return 100.0 * work / t.window_s / t.peak_flops
