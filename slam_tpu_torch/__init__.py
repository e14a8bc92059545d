"""PyTorch/CUDA port of ``slam_tpu``: the robust pose-graph backend on an
NVIDIA H100.

The JAX package ``slam_tpu`` is the reference each module here is held
against.  Host code of ``slam_tpu`` that imports no JAX (``config``,
``graph``, ``io.g2o``, ``solver.init``, ``solver.partition``, ``robust.pcm``,
``eval.metrics``, ``utils.logging``, ``viz.plot``) is shared by import; this
package never imports ``jax``.
"""
