"""Raw inputs of the benchmark, made from ``--seed``.

``clouds`` is a frozen copy of ``chip_smoke.py:clouds`` (the JAX package's
benchmark draws its clouds the same way): NsCircle-shaped point clouds
on a 4 x 2 box with a field window, targets, a Dirichlet mask and
``glob = 0.5``.  It returns plain dicts of numpy arrays; the program
(``graphs4cfd_tpu_torch.transforms``) and the plain reference
(``benchmark.reference``) each build their graphs from the same dicts.

``stream`` derives independent generators from one seed, one per use, so
that a run's clouds, weights, batch order, requests and checked sample
are all fixed by ``--seed`` and none moves when another use draws more.
"""
from __future__ import annotations

import numpy as np

#: what each generator of a run is drawn for
USES = ("clouds", "weights", "order", "requests", "sample")


def stream(seed: int, use: str) -> np.random.Generator:
    """The numpy generator of ``use`` for ``--seed`` ``seed``."""
    return np.random.default_rng([int(seed), USES.index(use)])


def torch_seed(seed: int, use: str) -> int:
    """A 63-bit seed for a ``torch.Generator``, derived as ``stream``."""
    return int(stream(seed, use).integers(0, 2 ** 63 - 1))


def clouds(num: int, n_nodes: int, seed: int, nf: int,
           target_steps: int = 10) -> list:
    """``num`` point clouds of ``n_nodes`` nodes, drawn in turn from one
    generator (``chip_smoke.py:clouds``): positions uniform on [0, 4] x
    [0, 2], ``field`` and ``target`` standard normal (``nf`` fields, and
    ``nf * target_steps`` target columns), ``omega`` 1 on about a tenth of
    the nodes, ``glob`` 0.5, ``bound`` 0."""
    rng = stream(seed, "clouds")
    out = []
    for _ in range(num):
        pos = (rng.random((n_nodes, 2)) * np.array([4.0, 2.0])).astype(
            np.float32)
        out.append({
            "pos": pos,
            "glob": np.full((n_nodes, 1), 0.5, np.float32),
            "field": rng.normal(size=(n_nodes, nf)).astype(np.float32),
            "target": rng.normal(size=(n_nodes, nf * target_steps)).astype(
                np.float32),
            "omega": (rng.random((n_nodes, 1)) < 0.1).astype(np.float32),
            "bound": np.zeros(n_nodes, np.uint8)})
    return out


#: the scale of the pool's first and last cloud: cloud ``i``'s field and
#: target are scaled by the ramp between them, so that the samples of a
#: batch differ in size by their index and a step that leaves out the first
#: or the last half of its batch reads another loss
FIELD_SCALE = (0.5, 2.0)


def inputs(traffic: dict, config: dict, seed: int) -> list:
    """The traffic's pool of clouds for ``seed``: ``clouds`` of the
    configuration's size, each scaled by ``FIELD_SCALE``'s ramp."""
    raws = clouds(traffic["pool"], config["n_nodes"], seed, config["nf"],
                  traffic["target_steps"])
    lo, hi = FIELD_SCALE
    for i, raw in enumerate(raws):
        s = np.float32(lo + (hi - lo) * i / max(len(raws) - 1, 1))
        raw["field"] = raw["field"] * s
        raw["target"] = raw["target"] * s
    return raws
