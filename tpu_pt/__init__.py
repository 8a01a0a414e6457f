"""tpu_pt — a progressive path-tracing framework in JAX.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
``fallinbryan/ACGPathTracing`` (an OptiX 8.0 megakernel path tracer):
OBJ scenes with name-classified diffuse/GGX-metallic/refractive BSDFs,
cosine-weighted importance sampling, area-light next-event estimation,
Russian-roulette termination with 1-28 bounce control, progressive
accumulation with sRGB tonemapping, and an interactive viewer — re-designed
as a wavefront renderer: fixed-shape ray SoA, ``lax.scan`` bounce loops,
counter-based RNG, dense/Pallas/LBVH intersection backends, and device-mesh
sharding for multi-device rendering.
"""

__version__ = "0.1.0"

import os as _os


def compile_cache_dir() -> str | None:
    """Where this package points JAX's persistent compilation cache: None
    when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then uses that
    directory), else ``.jax_cache`` beside the package. The path is part
    of the cache key, so it is fixed."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


def _enable_compile_cache():
    """Persistent XLA compilation cache (the reference's PTX/OptiX-IR disk
    cache, ``sutil.cpp:986-1029`` — compiled device code reused across
    runs)."""
    import jax
    path = compile_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compile_cache()

from .config import RenderConfig, Quirks  # noqa: F401
from .camera import Camera, Trackball, cornell_default_camera  # noqa: F401
from .render import (CameraArrays, RenderStats, render_frame,  # noqa: F401
                     render_wavefront, init_accum, image_to_host)
from .scene import load_scene, SceneArrays  # noqa: F401
from . import vmath  # noqa: F401  — public [..., 3] vector math (README §Library)
