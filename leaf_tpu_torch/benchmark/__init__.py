"""The CLIP benchmark suite of the port (no eager imports): zero-shot
classification clean and under the APGD cascade, zero-shot retrieval,
image-caption selection and linear probes over local datasets, and the
`python -m leaf_tpu_torch.benchmark.cli` command line that writes their
JSON results and CSV tables."""
