"""Host-side helpers."""

from rust_renderer_tpu_torch.utils.fps_timer import FpsTimer

__all__ = ["FpsTimer"]
