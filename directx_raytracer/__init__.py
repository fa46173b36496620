"""directx_raytracer — a JAX ray tracing framework.

A from-scratch JAX/XLA/Pallas rebuild of the capability surface of
BorisIvanov24/DirectX-RayTracer (see SURVEY.md): `.crtscene`
scene loading, interactive pinhole camera, LBVH construction + traversal,
wavefront Whitted rendering, the reference's 7 debug shading modes, and
multi-device ray sharding over a `jax.sharding.Mesh`.
"""

__version__ = "0.1.0"

from .models import (  # noqa: F401
    Camera,
    DeviceScene,
    Light,
    Material,
    MaterialType,
    Mesh,
    Scene,
    SceneSettings,
    Texture,
    TextureType,
    build_device_scene,
)
