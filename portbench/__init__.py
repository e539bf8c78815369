"""The benchmark of sunscreen_tpu_torch, the PyTorch and CUDA port: one
cell of BENCHMARK.json a run (`python3 portbench/run.py --help`)."""
