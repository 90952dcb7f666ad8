"""The benchmark of the PyTorch and CUDA port (`repro_torch`) on one
NVIDIA H100: offline batches served through `ServeEngine.generate`, at
published widths, in bf16.  `run.py` is its command; `BENCHMARK.json` at
the repository's root names its cells and metrics."""
