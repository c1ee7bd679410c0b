import os
import sys

# The CPU test tier runs on a virtual 8-device CPU mesh, whatever
# accelerator the machine has; the platform is pinned through jax.config
# before any backend initializes.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# small flat-capacity floor for the CPU tier: outputs are exact at any
# floor (capacity only; undersized caps retry with doubling), and the
# production 2^17 floor makes every tiny-genome core pay 131k-lane
# sorts on the virtual mesh
os.environ.setdefault("ASGART_MIN_CAP", "8192")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from asgart_tpu.compile_cache import configure_compile_cache  # noqa: E402

# CPU-mesh test compiles dominate the device-path files' wall time;
# the persistent cache makes re-runs compile-free
configure_compile_cache()

import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    # every test not explicitly marked soak belongs to the quick tier,
    # so both `-m quick` and `-m "not soak"` select the same set
    for item in items:
        if "soak" not in item.keywords:
            item.add_marker(pytest.mark.quick)
