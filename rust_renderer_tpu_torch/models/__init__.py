"""Scene content builders (the reference's prototype/src/scenes.rs)."""

from rust_renderer_tpu_torch.models.scenes import (
    create_atrium_standin,
    create_cornell_box_scene,
    create_cornell_standin_scene,
    create_cube_scene,
    create_metal_rough_spheres,
    create_restir_many_lights_scene,
    create_rtiow_scene,
    create_scene,
    create_sponza_scale_scene,
    create_sponza_scene,
)

__all__ = ["create_scene", "create_sponza_scene", "create_sponza_scale_scene",
           "create_cornell_box_scene", "create_cornell_standin_scene",
           "create_metal_rough_spheres", "create_cube_scene", "create_rtiow_scene",
           "create_restir_many_lights_scene", "create_atrium_standin"]
