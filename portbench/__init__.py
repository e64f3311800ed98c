"""The benchmark of `oai_analysis_2_tpu_torch` on NVIDIA H100 cards; see
`portbench/README.md`."""
