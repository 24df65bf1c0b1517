"""A reference module that renders nothing: it records each unit the check
hands it (`UNITS`) and the index of each unit it is asked to render
(`RENDERED`), so that a test can hold the check's replay against what the
program ran. A test gives both lists afresh."""

import contextlib

from rrt_reference.camera import Input

UNITS: list = []
RENDERED: list = []


class Reference:
    def __init__(self, config: dict, device, size: dict | None = None):
        self.input = Input()
        self.unit = None

    def step_camera(self) -> None:
        """No camera: the probe renders nothing."""

    def begin_unit(self, unit) -> None:
        self.unit = unit
        UNITS.append(unit)

    def lower_precision(self, kind):
        return contextlib.nullcontext()

    def render(self, state=None) -> dict:
        RENDERED.append(self.unit.index)
        return {}
