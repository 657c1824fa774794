"""Force a multi-device CPU host platform before jax initializes.

The explicit TP/PP engine tests (tests/test_decode_fastpath.py) shard over a
real mesh, so the suite runs with 8 host-platform devices — the same setting
CI exports.  An operator-provided XLA_FLAGS with an explicit device count is
left untouched.

Also registers the ``multidevice`` marker: suites that need the full
8-device mesh (e.g. the 3-axis (t, c, p) = (2, 2, 2) dynamic-schedule
tests) carry it, and the CI matrix leg that pins 2 devices skips them
cleanly instead of failing on mesh construction.
"""
import os

_FLAGS = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _FLAGS:
    os.environ["XLA_FLAGS"] = (
        _FLAGS + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402  (after the XLA_FLAGS export on purpose)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "multidevice: needs the full 8-device host platform "
        "(skipped automatically when fewer devices are configured)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the PyTorch port's kernels against their "
        "plain versions); skipped where none is present")


def pytest_collection_modifyitems(config, items):
    import jax
    if len(jax.devices()) >= 8:
        return
    skip = pytest.mark.skip(reason="needs 8 host-platform devices")
    for item in items:
        if "multidevice" in item.keywords:
            item.add_marker(skip)
