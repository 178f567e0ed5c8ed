"""The paper's Table 1 and Fig. 1 / Fig. 2 benchmarks on the port, each
runnable with ``python -m repro_torch.benchmarks.<name>``."""
