"""Scene content builders (the reference's prototype/src/scenes.rs)."""

from rust_renderer_tpu_torch.models.scenes import (
    create_atrium_standin,
    create_scene,
    create_sponza_scene,
)

__all__ = ["create_scene", "create_sponza_scene", "create_atrium_standin"]
