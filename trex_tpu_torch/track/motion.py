"""MotionRecord: position/angle time series with derivatives.

Counterpart of ``trex_tpu/track/motion.py`` (reference
data/MotionRecord.h:86-175): the per-assignment record of position (px),
angle and their derivatives (velocity, acceleration, angular velocity)
that the per-individual archives keep; px<->cm conversion happens at
read time.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional


@dataclass
class MotionRecord:
    time: float  # seconds
    x: float  # px
    y: float  # px
    angle: float = 0.0
    vx: float = 0.0  # px/s
    vy: float = 0.0
    ax: float = 0.0  # px/s^2
    ay: float = 0.0
    angular_velocity: float = 0.0
    angular_acceleration: float = 0.0

    @classmethod
    def create(cls, prev: Optional["MotionRecord"], time: float,
               x: float, y: float, angle: float = 0.0) -> "MotionRecord":
        r = cls(time=time, x=x, y=y, angle=angle)
        if prev is not None:
            dt = time - prev.time
            if dt > 0:
                r.vx = (x - prev.x) / dt
                r.vy = (y - prev.y) / dt
                r.ax = (r.vx - prev.vx) / dt
                r.ay = (r.vy - prev.vy) / dt
                da = angle_difference(angle, prev.angle)
                r.angular_velocity = da / dt
                r.angular_acceleration = (
                    r.angular_velocity - prev.angular_velocity
                ) / dt
        return r

    @property
    def pos(self):
        return (self.x, self.y)

    def speed(self, cm_per_pixel: float = 1.0) -> float:
        """speed in cm/s (px/s when cm_per_pixel == 1)."""
        return math.hypot(self.vx, self.vy) * cm_per_pixel

    def acceleration(self, cm_per_pixel: float = 1.0) -> float:
        return math.hypot(self.ax, self.ay) * cm_per_pixel

    def flip(self, prev: Optional["MotionRecord"]):
        """Rotate the stored angle by pi (posture direction fix)."""
        self.angle = normalize_angle(self.angle + math.pi)
        if prev is not None:
            dt = self.time - prev.time
            if dt > 0:
                da = angle_difference(self.angle, prev.angle)
                self.angular_velocity = da / dt


def normalize_angle(a: float) -> float:
    """Wrap to (-pi, pi]."""
    while a > math.pi:
        a -= 2 * math.pi
    while a <= -math.pi:
        a += 2 * math.pi
    return a


def angle_difference(a: float, b: float) -> float:
    return normalize_angle(a - b)
