import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def small_images():
    from repro.data.synthetic import make_image_dataset

    return make_image_dataset(n_train=4000, n_test=800, seed=0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason without one")
