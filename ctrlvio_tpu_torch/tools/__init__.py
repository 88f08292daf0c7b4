"""Measuring tools of the port (counterparts of the repository's `tools/`):
`profile_serve` (the batched megastep's per-op profile and B sweep),
`ne_ab` (the normal-equation assemblies and Schur solvers A/B) and
`accuracy_matrix` (the bench over ground-truth families, seeds and
speeds). Each runs as `python -m ctrlvio_tpu_torch.tools.<name>`."""
