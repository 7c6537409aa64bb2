"""The accelerator check and the persistent compile cache of the entry points.

The system runs on an NVIDIA GPU.  The CPU is used only when the user asks
for it explicitly with ``JAX_PLATFORMS=cpu`` (tests, rehearsals); any other
run that finds no GPU stops with a message instead of silently computing on
the host.
"""

from __future__ import annotations

import os
import subprocess

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def explicit_cpu() -> bool:
    """True when the user pinned JAX to the CPU with JAX_PLATFORMS=cpu."""
    return os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu"


def require_gpu(allow_explicit_cpu: bool = True) -> str:
    """Return the JAX platform the process computes on.

    Raises RuntimeError when no GPU is visible, unless the user set
    JAX_PLATFORMS=cpu and allow_explicit_cpu is true."""
    import jax

    try:
        platform = jax.default_backend()
    except RuntimeError as err:
        raise RuntimeError(f"JAX found no usable backend: {err}") from err
    if platform == "gpu":
        return platform
    if platform == "cpu" and allow_explicit_cpu and explicit_cpu():
        return platform
    raise RuntimeError(
        f"no GPU found (JAX platform {platform!r}). This program runs on "
        "an NVIDIA GPU; set JAX_PLATFORMS=cpu to run it on the CPU "
        "explicitly.")


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache.

    The path is part of the cache's key, so it is fixed: derived from the
    package location, never from a temp name, a pid or the time."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO_ROOT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; return its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here beyond caching every entry."""
    import jax

    path = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path


def device_report(cache_dir: str) -> list:
    """Lines naming what this process computes on: the JAX version, the
    platform, device kind and count, the compile-cache directory and, on a
    GPU, the card's name and power limit as nvidia-smi reports them (a card
    held below its maximum power limit runs slower under load)."""
    import jax

    dev = jax.devices()[0]
    lines = [f"jax {jax.__version__} platform={dev.platform} "
             f"kind={dev.device_kind} count={len(jax.devices())} "
             f"compile_cache={cache_dir}"]
    if dev.platform == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        lines += [f"nvidia-smi: {line}" for line in smi]
    return lines
