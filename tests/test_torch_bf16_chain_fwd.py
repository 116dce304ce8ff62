"""The bf16 chain forward's geometry (``csrc/mlp_tile_bf16.cuh``, kernel
``csrc/mlp_chain_fwd_bf16.cu``) on the CPU: the constants and formulas
that ``ops.fused_mlp`` repeats in Python are held against the C sources'
text, and every chain the bf16 paths launch fits one block with its
weights resident.  The kernel itself runs only on a card
(``tests/test_torch_cuda.py``)."""
import re
from pathlib import Path

import pytest

from graphs4cfd_tpu_torch.ops import _build, fused_mlp

CSRC = Path(fused_mlp.__file__).resolve().parent.parent / "csrc"
HEADER = "mlp_tile_bf16.cuh"


def _constants(name):
    text = (CSRC / name).read_text()
    return {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr int (\w+) = ([^;]+);", text)}


def _body(name, signature):
    """The body of the function whose definition starts with
    ``signature`` in ``csrc/<name>``, whitespace removed."""
    text = (CSRC / name).read_text()
    start = text.index(signature)
    body = re.match(r"[^{]*\{(.*?)\n\}", text[start:], re.S).group(1)
    return re.sub(r"\s+", "", body)


def test_chain_fwd_bf16_constants_match_the_source():
    c = _constants(HEADER)
    assert int(c["FWD_ROWS"]) == fused_mlp.BF16_FWD_ROWS == 64
    assert int(c["FWD_WG_MAX"]) == fused_mlp.BF16_FWD_WG_MAX == 4
    assert c["FWD_THREADS"] == "128 * FWD_WG_MAX"
    # a k16 step of a 128-column image: 16 rows x 128 bf16; the stash: a
    # 64 x 128 f32 pass; a slot: 128 x 128 bf16
    assert int(c["FWD_STEP_BYTES"]) == fused_mlp.BF16_FWD_STEP_BYTES \
        == 16 * 128 * 2
    assert int(c["FWD_AUX_BYTES"]) == fused_mlp.BF16_FWD_AUX_BYTES \
        == 64 * 128 * 4 == 128 * 128 * 2
    assert int(c["SMEM_LIMIT"]) == _build.MAX_SMEM


def test_chain_fwd_bf16_formulas_match_the_source():
    """The C text of the formulas that ``bf16_fwd_weight_bytes``,
    ``bf16_fwd_wg_bytes``, ``bf16_fwd_smem`` and ``bf16_fwd_geometry``
    repeat."""
    hdr = "__host__ __device__ inline "
    assert _body(HEADER, hdr + "bool fwd_wide(int n, const int* dims)") == (
        "for(intl=1;l<=n;++l)if(dims[l]>128)returntrue;returnfalse;")
    assert _body(HEADER, hdr + "size_t fwd_weight_bytes(int n,") == (
        "size_tb=0;for(intl=0;l<n;++l)b+=(size_t)((dims[l]+15)/16)*"
        "FWD_STEP_BYTES*((dims[l+1]+127)/128);returnb;")
    assert _body(HEADER, hdr + "int fwd_tile_cols(int n, const int* dims)") \
        == ("constintw=fwd_wide(n,dims)?256:128;returngn16::round64(dims[0])"
            ">w?gn16::round64(dims[0]):w;")
    assert _body(HEADER, hdr + "size_t fwd_wg_bytes(int n,") == (
        "constboolwide=fwd_wide(n,dims);return(size_t)FWD_ROWS*fwd_tile_cols"
        "(n,dims)*2*(wide?2:1)+(wide?FWD_AUX_BYTES:0)+(streamed?FWD_AUX_BYTES"
        ":0);")
    assert _body(HEADER, hdr + "size_t fwd_smem_bytes(int n,") == (
        "return1024+(streamed?0:fwd_weight_bytes(n,dims))+(size_t)g*"
        "fwd_wg_bytes(n,dims,streamed);")
    assert _body(HEADER, hdr + "int fwd_fit(int n, const int* dims,") == (
        "intg=FWD_WG_MAX;while(g>0&&fwd_smem_bytes(n,dims,streamed,g)>"
        "SMEM_LIMIT)--g;returng;")
    assert _body(HEADER, hdr + "bool fwd_streamed(int n, const int* dims)") \
        == "returnfwd_fit(n,dims,false)==0;"
    # the wrapper's query answers with the largest block
    chain = re.sub(r"\s+", "", (CSRC / "mlp_chain.cu").read_text())
    assert ("constboolstreamed=g4c::mlp16::fwd_streamed(n,dims);constintg="
            "g4c::mlp16::fwd_fit(n,dims,streamed);returng==0?0:g4c::mlp16::"
            "fwd_smem_bytes(n,dims,streamed,g);") in chain


@pytest.mark.parametrize("dims,want", [
    # 1 KB + the images (ceil(K / 16) steps of 4 KB) + 4 x a 16 KB tile
    ([2, 128, 128, 128], 1024 + (1 + 8 + 8) * 4096 + 4 * 16384),
    ([4, 128, 128], 1024 + (1 + 8) * 4096 + 4 * 16384),
    ([128, 128, 128], 1024 + 16 * 4096 + 4 * 16384),
    # a 258-wide input: 20 KB tiles, 17 + 16 steps: two warpgroups
    ([258, 128, 128, 128], 1024 + 33 * 4096 + 2 * 40960),
    # wide: two 32 KB tiles and the stash, one warpgroup
    ([40, 200, 256], 1024 + (3 * 2 + 13 * 2) * 4096 + 32768 * 3),
    # eight 128-wide layers do not fit: streamed, a 32 KB slot each
    ([128] * 9, 1024 + 4 * (16384 + 32768))])
def test_chain_fwd_bf16_smem_at_hand_counted_shapes(dims, want):
    streamed, g, smem = fused_mlp.bf16_fwd_geometry(dims)
    assert smem == want
    assert streamed == (dims == [128] * 9)


def _f32_tile_takes(dims):
    """Whether the f32 tile's formula (``mlp_tile.cuh:mlp_smem_floats``,
    at its 64-row tiles; two of them for outputs wider than 128) fits a
    block: the widths the bf16 chains took on that tile before they had
    their own."""
    wide = max(dims[1:]) > 128
    wmax = -(-max(dims) // 8) * 8
    ring = 2 * 128 * (32 + 4)
    return 4 * ((2 if wide else 1) * 64 * (wmax + 4) + ring) \
        <= _build.MAX_SMEM


def test_every_launched_chain_fits_one_block():
    """Every chain the bf16 paths launch (``MODEL_CHAINS``) keeps its
    weights resident in one block within 232,448 bytes, with four
    warpgroups (two for a 258-wide input); every chain of up to 8 layers
    and outputs up to 256 wide that the f32 tile took in bf16 fits too
    (inputs up to 760 wide, 376 with an output over 128), streamed where
    its images do not; a block of 512 threads may use 128 registers a
    thread, which its ``__launch_bounds__`` asks for."""
    from test_torch_bf16_wgrad import MODEL_CHAINS
    assert fused_mlp.BF16_FWD_WG_MAX * 128 * 128 <= 65536
    text = re.sub(r"\s+", "", (CSRC / "mlp_chain_fwd_bf16.cu").read_text())
    assert "__launch_bounds__(FWD_THREADS,1)mlp_chain_fwd_bf16_kernel" in text
    for dims, *_ in MODEL_CHAINS:
        streamed, g, smem = fused_mlp.bf16_fwd_geometry(dims)
        assert not streamed and 0 < smem <= _build.MAX_SMEM
        assert g == (2 if dims[0] == 258 else 4), dims
    taken = 0
    for k0 in (1, 2, 5, 129, 256, 376, 377, 505, 512, 760, 761):
        for n in range(1, 9):
            for w in (1, 128, 129, 256):
                dims = [k0] + [w] * n
                if _f32_tile_takes(dims):
                    taken += 1
                    assert fused_mlp.bf16_fwd_geometry(dims)[1] >= 1, dims
    assert taken > 0 and _f32_tile_takes([760, 128]) and \
        not _f32_tile_takes([761, 128]) and \
        not _f32_tile_takes([377, 256])
