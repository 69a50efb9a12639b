"""PyTorch/CUDA port of the shoeprint-retrieval pipeline.

A second package beside ``shoeprint_image_retrieval_tpu`` (the JAX
reference). It keeps the reference package's module names so each module's
counterpart is easy to find, and imports nothing from it: the tests hold the
two packages against each other on the same inputs.

Entry point: ``python -m shoeprint_image_retrieval_torch [run.toml]
[--device cuda|cpu]``. The main path (host ingest + native CLAHE,
normalisation, masked batched EfficientNetV2_M extraction, the variant
sweep, fused NCC scoring, ranks and the S-line) runs on one CUDA device;
the NCC scorer is the hand-written kernel in ``csrc/ncc_score.cu``.
"""
