"""The benchmark of the PyTorch/CUDA port (``shoeprint_image_retrieval_torch``):
crime-scene marks ranked against a FID-300-sized gallery. Run one cell once
with ``python -m retrieval_bench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``; ``README.md`` says how to add cells, configurations,
modes and metrics as files."""
