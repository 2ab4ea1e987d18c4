"""Process set-up shared by the entry points: which card, and the compile cache.

Every result the benchmark prints names the device it ran on
(:func:`device_record`), and every entry point keeps JAX's persistent
compilation cache in one fixed place (:func:`enable_compile_cache`).
"""

from __future__ import annotations

import os
import pathlib
import subprocess

import jax

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"

_NVIDIA_SMI = ("nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and no
    other directory is set here. Otherwise the cache lives at
    ``<repo>/.jax_cache`` — a fixed path, because the path is part of the
    cache key (a per-process or temporary directory never hits)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (one line per card), or a note saying why there is none."""
    try:
        out = subprocess.run(_NVIDIA_SMI, capture_output=True, text=True,
                             timeout=60, check=True)
    except FileNotFoundError:
        return "nvidia-smi: not found"
    except subprocess.CalledProcessError as e:
        return f"nvidia-smi: exit {e.returncode}: {e.stderr.strip()}"
    except subprocess.TimeoutExpired:
        return "nvidia-smi: timed out"
    return out.stdout.strip()


def device_record() -> dict:
    """Platform, kind and count of the JAX devices, plus ``nvidia-smi``."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": nvidia_smi()}
