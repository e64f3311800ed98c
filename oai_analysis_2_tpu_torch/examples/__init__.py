"""Training scripts of the port, run as modules (`python -m
oai_analysis_2_tpu_torch.examples.<name>`): the counterparts of the JAX
package's `examples/train_gradicon_synthetic.py` and
`examples/train_gradicon.py`, with the same arguments, environment
variables and checkpoint format."""
