"""Multi-process solvers on ``torch.distributed``: edge-parallel LM with
collective PCG (``distributed``), block-per-rank Schur LM
(``schur_dist``), and the meshes and local launcher they run on
(``mesh``)."""
