import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running CPU training tests")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips without one; run on the card)"
    )


@pytest.fixture(autouse=True, scope="session")
def _isolated_tune_cache(tmp_path_factory):
    """Point the repro.tune JSON cache at a throwaway dir for the whole run:
    tests never read a developer's pre-tuned cache nor write to ~/.cache."""
    import os

    path = tmp_path_factory.mktemp("repro-tune-cache")
    old = os.environ.get("REPRO_TUNE_CACHE")
    os.environ["REPRO_TUNE_CACHE"] = str(path)
    yield
    if old is None:
        os.environ.pop("REPRO_TUNE_CACHE", None)
    else:
        os.environ["REPRO_TUNE_CACHE"] = old
