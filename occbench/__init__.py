"""The benchmark of coocc_tpu_torch, the port of coocc_tpu to PyTorch and
CUDA on one NVIDIA H100: `python3 -m occbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` runs one cell of BENCHMARK.json once. See
run.py for how a cell is found and frames.py for its inputs."""
