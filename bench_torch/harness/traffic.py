"""Traffic: the seeded clock and the viewer's input, made from `--seed`
and a traffic file's parameters (``bench_torch/traffic/<mix>.json``).

A mix is one of two loops:
- "device": the camera held at the scene's viewpoint, frames rendered by
  `Application.run_on_device(frames_per_call)` and the returned image
  presented, call after call;
- "host": each frame one `Input.begin_frame`, the frame's input, then
  `Application.render_frame` and `Application.present`, as the viewer does.

The host loop's input is a user steering with the right mouse held: yaw
moves a uniform number of pixels a frame whose sign flips on segments,
pitch moves a little either way, and one of W/A/S/D (or none) is held on
segments. The generator keeps its own model of the camera (yaw, pitch and
a step of `speed` along the view) only to turn a key round where the path
would leave the box the file gives; the program's camera moves itself.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# Keys and what turns each round.
_OPPOSITE = {"w": "s", "s": "w", "a": "d", "d": "a"}


def seed_rng(seed: int, stream: str) -> np.random.Generator:
    """A generator for one named stream of `seed` (any whole number; the
    streams of one seed are independent of each other)."""
    words = [ord(c) for c in stream]
    return np.random.default_rng([int(seed) % 2 ** 64, *words])


class SeededClock:
    """A stand-in for the app's FpsTimer: its time starts at `t0` and
    advances `step` seconds for each frame the harness counts, so a run's
    frames, their random streams included, can be recomputed."""

    def __init__(self, t0: float, step: float = 1.0 / 60.0):
        self.t0 = float(t0)
        self.step = float(step)
        self.frames = 0
        self.fps = 0.0  # the HUD reads it

    def elapsed_seconds(self) -> float:
        return self.t0 + self.frames * self.step

    def calculate(self) -> None:
        """The app calls this once a frame or loop call; the harness
        advances the clock itself (`advance`)."""

    def advance(self, frames: int) -> None:
        self.frames += int(frames)


def clock_for(seed: int, traffic: dict) -> SeededClock:
    lo, hi = traffic.get("clock_start_s", [0.0, 600.0])
    return SeededClock(seed_rng(seed, "clock").uniform(lo, hi),
                       traffic.get("clock_step_s", 1.0 / 60.0))


def frames_per_unit(traffic: dict) -> int:
    """The frames one unit of the mix renders: 1 in the host loop, and
    `frames_per_call` in the device loop."""
    return 1 if traffic["loop"] == "host" else int(traffic["frames_per_call"])


@dataclasses.dataclass(frozen=True)
class FrameInput:
    """What the user does in one frame of the host loop."""

    yaw_px: float
    pitch_px: float
    key: str | None  # one of "wasd", or None


def _forward(yaw: float, pitch: float) -> np.ndarray:
    """The view direction for yaw (0 faces -Z) and pitch (radians)."""
    cp = math.cos(pitch)
    return np.array([-math.sin(yaw) * cp, math.sin(pitch), -math.cos(yaw) * cp])


def orbit_inputs(traffic: dict, start_pos, start_target):
    """The host loop's inputs, frame after frame, without end, drawn from
    the mix's own `path_seed`: every run's camera takes the same path, so
    every run renders the same views (a path drawn from the run's seed
    moved the frame time by ~10% from seed to seed, against ~2% between
    two runs of one seed). The run's seed sets the clock, and with it every
    random stream of every frame. `start_pos` / `start_target` are the
    scene's viewpoint. Each quantity is drawn from its own stream, so how
    many frames a run takes shifts no draw against another."""
    p = traffic["input"]
    seed = int(p["path_seed"])
    yaw_rng, pitch_rng = seed_rng(seed, "yaw"), seed_rng(seed, "pitch")
    flip_rng, key_rng = seed_rng(seed, "flip"), seed_rng(seed, "keys")
    deg = math.radians(p["degrees_per_px"])
    lo = np.asarray(p["bounds_min"], float)
    hi = np.asarray(p["bounds_max"], float)
    # The generator's own model of the camera, to keep the path in bounds.
    pos = np.asarray(start_pos, float)
    fwd0 = np.asarray(start_target, float) - pos
    fwd0 /= np.linalg.norm(fwd0)
    yaw = math.atan2(-fwd0[0], -fwd0[2])
    pitch = math.asin(max(-1.0, min(1.0, fwd0[1])))
    sign = 1.0 if flip_rng.random() < 0.5 else -1.0
    flip_left = key_left = 0
    key = None
    while True:
        if flip_left == 0:
            sign = -sign
            flip_left = int(flip_rng.integers(p["yaw_flip_frames"][0],
                                              p["yaw_flip_frames"][1] + 1))
        if key_left == 0:
            key_left = int(key_rng.integers(p["key_segment_frames"][0],
                                            p["key_segment_frames"][1] + 1))
            key = (None if key_rng.random() < p["no_key_share"]
                   else "wasd"[int(key_rng.integers(4))])
        flip_left -= 1
        key_left -= 1
        dx = sign * float(yaw_rng.uniform(*p["yaw_px"]))
        dy = float(pitch_rng.uniform(*p["pitch_px"]))
        yaw -= deg * dx
        pitch = min(max(pitch - deg * dy, -p["max_pitch"]), p["max_pitch"])
        if key is not None:
            f = _forward(yaw, pitch)
            r = np.cross(f, [0.0, 1.0, 0.0])
            r /= max(np.linalg.norm(r), 1e-12)
            step = {"w": f, "s": -f, "d": r, "a": -r}
            nxt = pos + p["speed"] * step[key]
            if np.any(nxt < lo) or np.any(nxt > hi):
                # Turned round for the rest of the segment.
                key = _OPPOSITE[key]
                nxt = pos + p["speed"] * step[key]
                if np.any(nxt < lo) or np.any(nxt > hi):
                    nxt = pos  # a corner: the model stays put
            pos = nxt
        yield FrameInput(dx, dy, key)


def apply_input(inp, frame: FrameInput, mouse: list) -> None:
    """Frame `frame`'s input into the app's `Input` (after its
    begin_frame): the right mouse held, the mouse moved by the frame's
    pixels (`mouse` holds the pointer's position and is updated), the
    frame's key held and the others released."""
    inp.right_mouse_down = True
    mouse[0] += frame.yaw_px
    mouse[1] += frame.pitch_px
    inp.move_mouse(mouse[0], mouse[1])
    for k in "wasd":
        if k == frame.key:
            inp.set_key_down(k)
        else:
            inp.set_key_up(k)
