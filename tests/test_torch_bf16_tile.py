"""The bf16 GN tile's geometry (``csrc/gn_tile_bf16.cuh``) on the CPU: the
constants and the shared-memory formula that ``ops.gn_block`` repeats in
Python are held against the C source's text, and every shape the bf16
kernels take gets a tile that fits one block's shared memory.  The f32
tile (``csrc/gn_tile.cuh``) keeps its geometry."""
import re
from pathlib import Path

import pytest
import torch

from graphs4cfd_tpu_torch.ops import _build
from graphs4cfd_tpu_torch.ops import gn_block as gn_op

CSRC = Path(gn_op.__file__).resolve().parent.parent / "csrc"
BF = torch.bfloat16


def _constants(text):
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = ([0-9 +]+?);", text.replace("4096 + 1024",
                                                            "5120"))}


def test_f32_tile_keeps_its_geometry():
    """f32: min(16, 96 // k) receivers, as ``gn_tile.cuh``'s NR and
    ER_MAX give them."""
    c = _constants((CSRC / "gn_tile.cuh").read_text())
    assert (c["NR"], c["ER_MAX"]) == (16, 96)
    for k in range(2, 97):
        assert gn_op.tile_receivers(k) == min(16, 96 // k)
        assert gn_op.tile_receivers(k, torch.float32, 256, 1) == min(
            16, 96 // k)


def test_bf16_tile_constants_match_the_source():
    """The Python geometry reads the header's constants."""
    text = (CSRC / "gn_tile_bf16.cuh").read_text()
    c = _constants(text)
    assert c["NODE_ROWS"] == gn_op.BF16_NODE_ROWS
    assert c["ER_MAX"] == gn_op.BF16_ER_MAX
    assert c["LDN"] == gn_op.BF16_LDN
    assert c["W_BYTES"] == gn_op.BF16_W_BYTES
    assert c["VBLOCK_BYTES"] == gn_op.BF16_VBLOCK_BYTES
    assert c["SCRATCH_BYTES"] == gn_op.BF16_SCRATCH_BYTES
    assert c["SMEM_LIMIT"] == _build.MAX_SMEM
    # the formula that bf16_tile_smem repeats
    body = re.search(r"inline size_t smem_bytes\(.*?\{(.*?)\n\}", text,
                     re.S).group(1)
    flat = re.sub(r"\s+", "", body)
    assert flat == ("constsize_tnf=(size_t)npb*LDN*4;return1024+(size_t)"
                    "round64(npb*k)*256+(size_t)vblocks(fv)*VBLOCK_BYTES+2*"
                    "VBLOCK_BYTES+W_BYTES+nf*(ne==1?2:1)+SCRATCH_BYTES;")
    vb = re.search(r"inline int vblocks\(int fv\) \{(.*?)\n\}", text,
                   re.S).group(1)
    assert re.sub(r"\s+", "", vb) == "returnround64(fv)/64>2?round64(fv)/64:2;"


@pytest.mark.parametrize("ne", [1, 2, 8])
def test_every_bf16_shape_gets_a_tile_that_fits(ne):
    """Every k (2-96) and node input fv (1-256) the bf16 kernels take:
    at least one receiver, at most 64 and at most 384 // k, edge rows
    padded to whole 64-row m-tiles, and the tile within 232,448 bytes."""
    for k in range(2, 97):
        for fv in range(1, 257):
            n = gn_op.tile_receivers(k, BF, fv, ne)
            assert 1 <= n <= min(64, 384 // k)
            assert gn_op.bf16_tile_smem(n, k, fv, ne) <= 232448
            if n < min(64, 384 // k):  # as many as fit
                assert gn_op.bf16_tile_smem(n + 1, k, fv, ne) > 232448


def test_bf16_main_paths_take_64_receivers():
    """MuS and gMuS levels (k = 6, fv 128 and 256, 3-layer edge chains)
    and REMuS's EdgeMP (k = 5, 2 layers) get whole 64-receiver tiles."""
    assert gn_op.tile_receivers(6, BF, 128, 3) == 64
    assert gn_op.tile_receivers(6, BF, 256, 3) == 64
    assert gn_op.tile_receivers(5, BF, 128, 2) == 64
