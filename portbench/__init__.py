"""The benchmark of `leaf_tpu_torch` on NVIDIA H100 cards: `python3 -m
portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`."""
