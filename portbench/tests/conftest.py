import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips inside the test without one)")
    # tiny models: one thread a worker, so that workers side by side do not
    # fight over the cores
    torch.set_num_threads(1)
