"""Host-side helpers."""

from rust_renderer_tpu_torch.utils.fps_timer import FpsTimer

__all__ = ["FpsTimer", "require_port_values"]


def require_port_values(where: str, why: str, **given) -> None:
    """Raise a ValueError naming `where` and `why` unless each given keyword
    holds the one value the port takes: given as name=(value, port_value).
    For JAX parameters whose other values select code the port does not
    have; a call with the port's values runs as in the JAX package."""
    for name, (value, port_value) in given.items():
        if value != port_value:
            raise ValueError(f"{where}: {name}={value!r} is not ported ({why}); "
                             f"the port takes only {name}={port_value!r}")
