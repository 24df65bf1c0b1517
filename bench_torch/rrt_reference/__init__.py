"""The benchmark's plain reference: a renderer in plain PyTorch, written
from the semantics of the renderer's JAX package (its scene definitions,
camera rig, ops and passes) and sharing no code with the package under
test or with the JAX package. It makes its own scene, tree, shadow maps
and environment, and renders with plain tensor code, one frame at a time.

A configuration names the module that renders its frames (`reference`
in its file under ``configs/``): ``rrt_reference.raster`` renders the
RASTERIZED frame."""
