"""Fixtures shared by the port's test files that run flows of both
packages. A test module imports a fixture by name to use it:

    from _torch_fixtures import _fresh_metric_registries  # noqa: F401
"""

import pytest


@pytest.fixture(autouse=True)
def _fresh_metric_registries():
    """Zero both packages' metric registries after each test: the flows
    here count into them, and a later test in this process, of either
    package, that reads an absolute count must see only its own."""
    yield
    from ray_tpu.core.metrics import registry as jregistry
    from ray_tpu_torch.core.metrics import registry as tregistry

    jregistry.fresh()
    tregistry.fresh()
