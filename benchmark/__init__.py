"""The benchmark of `llama3np_tpu_torch` (the PyTorch and CUDA port):
`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`, from the root of a checkout, on a machine with the card."""
