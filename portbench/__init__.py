"""The benchmark of the PyTorch / CUDA port (``mvkpconv_tpu_torch``) on one
H100: ``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (``BENCHMARK.json`` lists the cells)."""
