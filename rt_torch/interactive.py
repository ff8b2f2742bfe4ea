"""Orbit-camera controller — counterpart of ``rt/interactive.py``: the
interaction model of the reference's camera controller without a window
system.  Drag orbits, scroll zooms, phi is clamped to 0.1..pi-0.1, and
``to_camera()`` gives the w = 0 interactive camera (focal length 10, no
blur).  A front end must reset the progressive renderer whenever
``has_moved`` is set."""

from __future__ import annotations

import math

from rt_torch.core.camera import Camera, orbit_uniform


class OrbitCamera:
    def __init__(self, aspect_ratio: float = 1.0):
        self.radius = 5.0
        self.theta = 0.0
        self.phi = math.pi / 4.0
        self.fov = math.radians(45.0)
        self.aspect_ratio = aspect_ratio
        self.target = (0.0, 0.0, 0.0)
        self.zoom_speed = 0.1
        self.orbit_speed = 0.01
        self.min_radius = 1.0
        self.max_radius = 20.0
        self.has_moved = False
        self._dragging = False
        self._last = (0.0, 0.0)
        self.update_position()

    def update_position(self):
        """Spherical to cartesian, with the phi clamp."""
        self.phi = min(max(self.phi, 0.1), math.pi - 0.1)
        x = self.radius * math.sin(self.phi) * math.cos(self.theta)
        y = self.radius * math.cos(self.phi)
        z = self.radius * math.sin(self.phi) * math.sin(self.theta)
        tx, ty, tz = self.target
        self.position = (tx + x, ty + y, tz + z)
        self.has_moved = True

    def handle_mouse_input(self, pressed: bool):
        self._dragging = pressed

    def handle_mouse_motion(self, x: float, y: float):
        """A drag orbits (y inverted)."""
        if self._dragging:
            dx = x - self._last[0]
            dy = y - self._last[1]
            self.theta += dx * self.orbit_speed
            self.phi -= dy * self.orbit_speed
            self.update_position()
        self._last = (x, y)

    def handle_scroll(self, amount: float):
        self.radius -= amount * self.zoom_speed * self.radius
        self.radius = min(max(self.radius, self.min_radius), self.max_radius)
        self.update_position()

    def resize(self, width: int, height: int):
        self.aspect_ratio = width / height

    def reset_movement_flag(self):
        self.has_moved = False

    def to_camera(self) -> Camera:
        return orbit_uniform(self.position, self.target, self.fov)
