"""Test configuration: run everything on a virtual 8-device CPU mesh.

The reference has no multi-device tests at all (SURVEY.md §4); we add what
it lacks: every sharding-aware test sees 8 XLA host-platform devices, so
mesh behaviour is exercised without accelerators.  The platform is fixed
here, before any backend initializes.  ``PBRT_TPU_TEST_GPU=1`` leaves
the default backend alone, so the suite (and the ``gpu``-marked tests)
run on the card instead: ``PBRT_TPU_TEST_GPU=1 python -m pytest tests/
-m gpu``.

Fixtures:
  * tests marked ``gpu`` skip unless the default backend is a GPU — the
    decision is taken here, at run time, never at import or collection;
  * ``gpu_kernel_interpret`` runs the GPU traversal kernel
    (``ops/traverse.walk_gpu``) in Pallas interpret mode, so its
    arithmetic and control flow are tested on the CPU.
"""

import functools
import os

import pytest

if os.environ.get("PBRT_TPU_TEST_GPU", "0") in ("", "0"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs a GPU (run with PBRT_TPU_TEST_GPU=1 on the card)")


@pytest.fixture
def gpu_kernel_interpret(monkeypatch):
    from pbrt_tpu.ops import traverse

    monkeypatch.setattr(
        traverse, "walk_gpu",
        functools.partial(traverse.walk_gpu, interpret=True),
    )
