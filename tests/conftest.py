"""Test configuration: force the CPU backend with a virtual 8-device mesh.

Tests always run on the CPU with 8 virtual devices (SURVEY.md §4: multi-host
layers are tested on a simulated CPU mesh), set through jax.config before
any backend initializes. What runs only on the card is a phase of
``chip_smoke.py``, not a skipped test.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.Generator(np.random.PCG64(1234))


def random_host_csr(m, n, density, rng, pattern="uniform"):
    """Small random HostCSR for unit tests."""
    import scipy.sparse as sp
    from spmv_research_tpu.core.host import HostCSR

    mat = sp.random(m, n, density=density, format="csr",
                    random_state=np.random.RandomState(int(rng.integers(2**31))),
                    data_rvs=lambda k: rng.uniform(-1, 1, k))
    mat.sort_indices()
    return HostCSR.from_scipy(mat)


@pytest.fixture
def small_csr(rng):
    return random_host_csr(100, 80, 0.05, rng)


@pytest.fixture
def square_csr(rng):
    return random_host_csr(128, 128, 0.06, rng)
