"""Test configuration: run everything on a virtual 8-device CPU mesh.

The platform and device count are set before any backend initializes.
Tests that need the accelerator carry the ``gpu`` marker and skip through the
``gpu_device`` fixture when none is present; whether a card exists is decided
inside that fixture, never at import or collection time.
"""

import os

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

# Compile cost dominates this suite (many small shapes); cache executables
# across runs in the same place the program uses (utils/cache.py).
from mcqueens.utils import cache  # noqa: E402

cache.enable()
os.environ["JAX_PLATFORMS"] = "cpu"  # for subprocesses we spawn


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip when this machine has none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
    return devices[0]
