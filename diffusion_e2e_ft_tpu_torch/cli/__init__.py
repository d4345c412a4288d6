"""Command-line entry points (python -m diffusion_e2e_ft_tpu_torch.cli.<name>),
the JAX package's CLIs with the same arguments plus `--device` (default cuda):

  run_marigold   folder-of-images depth/normal inference
  run_geowizard  folder-of-images joint inference
  infer          eval-dataset RGB-only inference dump
  eval_depth     alignment + 10-metric depth evaluation
  eval_normals   DSINE normals benchmark
  serve          HTTP inference server
  train          E2E fine-tuning (depth, normals, GeoWizard joint)

Every CLI accepts `@file.txt` argument files (the DSINE convention); the
inference CLIs dump their resolved arguments next to their outputs.
"""
