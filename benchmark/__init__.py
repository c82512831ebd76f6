"""The benchmark of the PyTorch and CUDA port (``ctrlv_tpu_torch``): run one
cell with ``python -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>``."""
