"""Runtime report of the kernels (port of ``graphs4cfd_tpu/config.py``).

``fast_path_report(reset=False)`` is the JAX report's counterpart
(``config.py:66``): the kernel wrappers that launched their kernel, with
their launch counts (``ops.launch_counts()``), sorted by name.

The JAX module's other names have no counterpart here, by design:

* ``pallas_enabled`` / ``use_pallas`` (``GRAPHS4CFD_USE_PALLAS``): the
  port picks the kernel by the tensor's device, a CUDA tensor's wrapper
  launches its kernel and a CPU tensor's runs the plain version; there is
  no switch to turn a kernel off on a card.
* ``record_choice``, ``suppress_choice_recording`` and
  ``kernel_choices``: the JAX package records which route or gather plan
  each dispatch site chose; the port has no plans or routes to choose
  between, so the launch counters are the whole record.
* ``ablation`` (``GRAPHS4CFD_ABLATE``): its values steer the TPU's
  sender-gather routes (``graphs4cfd_tpu/nn/blocks.py:62-90``) and XLA's
  scheduling of the halo ``all_to_all`` (``:112-117``).  In the port the
  GN kernels load sender rows by index, and the halo exchange is a
  blocking ``all_to_all_single`` that runs before any local term
  (``parallel/collectives.py:_all_to_all``, the ``exchange`` of
  ``parallel/graph_parallel.py``), so neither has anything to ablate;
  the port reads no such variable.
"""
from __future__ import annotations


def fast_path_report(reset: bool = False) -> dict:
    """The nonzero ``ops.launch_counts()`` sorted by name; with ``reset``
    every counter is set to 0 after the report is taken."""
    from .ops import launch_counters, launch_counts
    out = {k: v for k, v in sorted(launch_counts().items()) if v}
    if reset:
        for fn in launch_counters().values():
            fn.launches = 0
    return out
