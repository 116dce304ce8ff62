"""The control of each cell comes out not correct: the reference put in
the program's place in the precision below the cell's (fp8 for the bf16
training cells, TF32 for the f32 rollout cells), judged by the cell's own
limits; and in training cells the planted fault "half of the batch left
out", its first half kept (every other sample left out is not seen in
``mus3.train.bf16``, where its samples' gradients are alike).  On the CPU at tiny sizes (``readings`` on the tiny cells); on the
card (marked ``cuda``) at the cells' own sizes, where the program's own
numbers also have to pass."""
from __future__ import annotations

import pytest

from benchmark import harness, readings

from .conftest import TINY
from .test_bench_layout import CELLS

FAULTS = ("half_first",)


def _read(root, cell, seeds, device):
    return readings.main(["--workload", cell, "--seeds",
                          *map(str, seeds)], device=device, root=root)


@pytest.mark.parametrize("cell", [t for t, *_ in TINY
                                  if not t.endswith("train32")])
def test_the_control_and_the_faults_fail_at_a_tiny_size(tiny_root, cell,
                                                        few_threads):
    limits = harness.resolve(cell, tiny_root).limits
    for line in _read(tiny_root, cell, [11, 12], "cpu"):
        assert not harness.judge(line["control"], limits)[0], line
        for fault in FAULTS:
            if fault in line:
                assert not harness.judge(line[fault], limits)[0], line


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes_and_the_control_fails_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' own sizes run the port's "
                    "kernels")
    limits = harness.resolve(cell).limits
    for line in _read(harness.ROOT, cell, [2147483701], None):
        assert harness.judge(line["program"], limits)[0], line
        assert not harness.judge(line["control"], limits)[0], line
        for fault in FAULTS:
            if fault in line:
                assert not harness.judge(line[fault], limits)[0], line
