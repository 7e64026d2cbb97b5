"""The benchmark of the PyTorch and CUDA port (`repro_torch`): see
`portbench/run.py` and PERF.md."""
