"""The JAX package's example scripts as modules of the port, run with
`python -m oai_analysis_2_tpu_torch.examples.<name>`; each takes its
script's arguments and environment variables and prints its lines, and
`main(argv=None, device=None)` (None: the card) returns the printed
numbers as a dict:

- `train_gradicon_synthetic`, `train_gradicon`: the GradICON trainers
  (`examples/train_gradicon_synthetic.py`, `examples/train_gradicon.py`),
  same checkpoint format;
- `validate_registration`: known-deformation recovery error in mm on a
  phantom (`examples/validate_registration.py`);
- `validate_registration_cross`: image match, inverse consistency and
  Jacobian statistics across two phantoms
  (`examples/validate_registration_cross.py`);
- `full_demo`: the whole pipeline with atlas maps and 2D projection,
  `phantom` with no download (`examples/full_demo.py`);
- `segmentation_demo`, `thickness_demo`, `cohort_demo`: segmentation,
  thickness and a cohort from NIfTI files (`examples/segmentation_demo.py`,
  `examples/thickness_demo.py`, `examples/cohort_demo.py`).
"""
