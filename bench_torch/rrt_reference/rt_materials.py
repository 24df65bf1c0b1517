"""The path tracer's material field that `scene.Scene` does not carry: each
material's scattering property, the fuzz of a metal (type 1) or the index
of refraction of a dielectric (type 2), and 0 for the others.

Only the atrium's clutter spheres have one. The atrium draws them last,
each from one generator seeded 42, in this order: the position's x and z,
the colour's three channels, the type (an integer in [0, 3)) and the
property (uniform in [0, 1.5)). Their materials follow the floor's, the
four walls' and, at each of the `columns` positions, the two columns' and
their caps'."""

from __future__ import annotations

import numpy as np
import torch

# builder -> (columns, clutter spheres) of the atrium it builds.
ATRIUMS = {"create_sponza_scale_scene": (12, 48)}


def clutter(columns: int, count: int) -> list[tuple[int, int, float]]:
    """(material index, type, property) of each clutter sphere."""
    rng = np.random.default_rng(42)
    first = 1 + 4 + 4 * columns
    out = []
    for i in range(count):
        rng.uniform(-10, 10)
        rng.uniform(-3, 3)
        for _ in range(3):
            rng.uniform(0.2, 0.9)
        kind = int(rng.integers(0, 3))
        out.append((first + i, kind, float(rng.uniform(0.0, 1.5))))
    return out


def rt_prop(builder: str, scene) -> torch.Tensor:
    """(M,) float32: the property of each material of `scene`, which
    `builder` built."""
    prop = np.zeros(scene.mat_rt_type.shape[0], np.float32)
    if builder in ATRIUMS:
        kinds = scene.mat_rt_type.cpu().numpy()
        for index, kind, value in clutter(*ATRIUMS[builder]):
            if kinds[index] != kind:
                raise ValueError(f"material {index} of {builder} has type {kinds[index]}, "
                                 f"its clutter sphere {kind}")
            prop[index] = value
    return torch.as_tensor(prop, device=scene.mat_rt_type.device)
