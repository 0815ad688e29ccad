def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: subprocess-spawning integration tests (multi-device / "
        "multi-process bit-identity); deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (the PyTorch port's CUDA "
        "kernels); skips where torch.cuda.is_available() is False")
