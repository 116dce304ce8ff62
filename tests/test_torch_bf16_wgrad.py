"""The bf16 weight-gradient kernel (``csrc/wgrad_bf16.cu``) and the bf16
chain backward's tile (``csrc/mlp_tile_bf16.cuh``) on the CPU: the geometry
that ``ops.wgrad`` and ``ops.fused_mlp`` repeat in Python (ring stages,
stage rows, tile rows, shared-memory bytes, the chunk plan) is held against
the C sources' text, every shape the bf16 paths launch fits one block's
shared memory, and ``wgrad_chunk`` stays a function of the row count
alone.  The kernels themselves run only on a card
(``tests/test_torch_cuda.py``)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from graphs4cfd_tpu_torch.ops import _build, fused_mlp, launch_counts, wgrad

CSRC = Path(wgrad.__file__).resolve().parent.parent / "csrc"
#: the shared memory of one SM of an H100 (228 KB) and what the card keeps
#: of it for each resident block (1 KB)
SM_SMEM, BLOCK_RESERVED = 233472, 1024


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


def test_wgrad_bf16_constants_match_the_source():
    c = _constants("wgrad_bf16.cu")
    assert int(c["STAGE_ROWS"]) == wgrad.BF16_STAGE_ROWS == 64
    assert int(c["STAGES"]) == wgrad.BF16_STAGES
    assert int(c["TILE_BYTES"]) == wgrad.BF16_TILE_BYTES == 64 * 128 * 2
    assert c["STAGE_BYTES"] == "2 * TILE_BYTES"
    assert c["SMEM_BYTES"] == "1024 + STAGES * STAGE_BYTES"
    assert wgrad.bf16_smem() == 1024 + wgrad.BF16_STAGES * 2 * 16384


def test_wgrad_bf16_two_blocks_share_an_sm():
    """The ring leaves room for two blocks an SM (the kernel's
    ``__launch_bounds__(THREADS, 2)``), and a stage is whole k16 steps."""
    text = (CSRC / "wgrad_bf16.cu").read_text()
    assert "__launch_bounds__(THREADS, 2)" in text
    assert 2 * (wgrad.bf16_smem() + BLOCK_RESERVED) <= SM_SMEM
    assert wgrad.bf16_smem() <= _build.MAX_SMEM
    assert wgrad.BF16_STAGE_ROWS % 16 == 0


def test_split_rule_matches_the_source():
    c = _constants("wgrad.cuh")
    assert (int(c["WG_CHUNK"]), int(c["WG_MIN_CHUNK"]),
            int(c["WG_MIN_CHUNKS"])) == (wgrad.WG_CHUNK, wgrad.WG_MIN_CHUNK,
                                         wgrad.WG_MIN_CHUNKS)
    assert c["MAX_PRODS"] == "2 * MAX_LAYERS + 2"
    assert int(_constants("tile.cuh")["MAX_LAYERS"]) * 2 + 2 == \
        wgrad.MAX_PRODS
    assert _body("wgrad.cuh", "inline int wgrad_chunk(int64_t rows)") == (
        "intc=WG_CHUNK;while(c>WG_MIN_CHUNK&&(rows+c-1)/c<WG_MIN_CHUNKS)c/="
        "2;returnc;")


def test_wgrad_chunk_is_a_function_of_the_row_count_alone():
    """The plan takes the chunk from the rows alone (not K, N, the type or
    the launch), so the order of every sum is fixed for a shape."""
    prod = _body("wgrad.cuh", "  void prod(const X* x")
    assert prod.startswith("constintchunk=wgrad_chunk(rows);")
    assert "(int64_trows)" in re.sub(r"\s+", "", (CSRC / "wgrad.cuh").read_text(
    ).split("inline int wgrad_chunk")[1].split("{")[0])
    for rows in [1, 63, 64, 255, 256, 257, 16383, 16384, 16385, 40448,
                 131072, 242688, 512000, 10 ** 7]:
        c = wgrad.wgrad_chunk(rows)
        # the largest of 2048, 1024, 512, 256 that gives 64 partials
        assert c in (256, 512, 1024, 2048)
        assert c == 256 or -(-rows // c) >= 64
        assert c == 2048 or -(-rows // (2 * c)) < 64


@pytest.mark.parametrize("rows,chunk", [(14336, 256), (40448, 512),
                                        (102400, 1024), (242688, 2048),
                                        (512000, 2048), (3072, 256), (1, 256)])
def test_wgrad_chunk_at_the_main_paths_rows(rows, chunk):
    assert wgrad.wgrad_chunk(rows) == chunk


def test_plan_of_a_mus_level1_backward():
    """The GN backward at MuS level 1 (V = 40448, k = 6, 3-layer chains):
    eight products, three over the 242,688 edge rows in 2048-row chunks
    (119 each) and five over the receivers in 512-row chunks (79 each),
    one 128-column slice of K each: 752 blocks."""
    products = wgrad.gn_products(40448, 6, 128, 128, [384, 128, 128, 128],
                                 [256, 128, 128, 128])
    assert [(r, K, N) for r, K, N, _ in products] == (
        [(242688, 128, 128), (40448, 128, 128)] + [(242688, 128, 128)] * 2
        + [(40448, 128, 128)] * 4)
    assert [xb for *_, xb in products] == [True, True, False, False, False,
                                           True, False, False]
    per, blocks, floats = wgrad.plan([p[:3] for p in products])
    assert per[0] == (2048, 119, 1) and per[1] == (512, 79, 1)
    assert blocks == 3 * 119 + 5 * 79 == 752
    assert floats == blocks * 128 * 128


def test_plans_mirror_the_backwards():
    """``gn_products`` and ``chain_products`` list the products in the order
    and with the operand types of ``gn_bwd_plan`` and ``mlp_bwd_plan``
    (the first edge layer's e and v, the layer inputs written in f32, v
    again against the first node layer's cotangent; a chain's x, or its f32
    SELU(x) with preact_input)."""
    gn = re.sub(r"\s+", "", (CSRC / "gn_block_bwd.cu").read_text())
    order = re.findall(r"p\.prod\((a\.\w+(?:\[\w+(?:-1)?\])?),", gn)
    assert order == ["a.e", "a.v", "a.xe[l-1]", "a.xn[0]", "a.v", "a.xn[l]"]
    assert "float*xe[MAX_LAYERS];" in re.sub(r"\s+", "", (
        CSRC / "gn_tile.cuh").read_text())
    chain = re.sub(r"\s+", "", (CSRC / "mlp_chain_bwd.cu").read_text())
    assert "a.xo[0]=a.preact?p.take((size_t)rows*a.dims[0]):nullptr;" in chain
    assert ("if(a.xo[l]!=nullptr)p.prod(a.xo[l],d,rows,a.dims[l],a.dims[l+1]"
            in chain)
    assert wgrad.chain_products(10, [2, 128, 128, 3], False) == [
        (10, 2, 128, True), (10, 128, 128, False), (10, 128, 3, False)]
    assert wgrad.chain_products(10, [128, 128, 128], True) == [
        (10, 128, 128, False), (10, 128, 128, False)]


def test_chain_bwd_bf16_tile_matches_the_source():
    c = _constants("mlp_tile_bf16.cuh")
    assert int(c["THREADS"]) == fused_mlp.BF16_BWD_THREADS == 512
    assert int(c["ROWS"]) == fused_mlp.BF16_BWD_ROWS == 128
    assert c["E_BYTES"] == "ROWS * 256"
    assert fused_mlp.BF16_BWD_E_BYTES == 128 * 256
    assert c["CS_BYTES"] == "4096 + 1024"
    assert fused_mlp.BF16_CS_BYTES == 8 * 128 * 4 + 4 * 64 * 4
    assert int(c["XS_LD"]) == fused_mlp.BF16_XS_LD
    assert c["XS_BYTES"] == "ROWS * XS_LD * 4"
    assert int(c["SMEM_LIMIT"]) == _build.MAX_SMEM
    assert int(_constants("gn_tile_bf16.cuh")["W_BYTES"]) == \
        fused_mlp.BF16_W_BYTES
    # the formulas that bf16_bwd_smem and bf16_bwd_xs_tiles repeat
    assert _body("mlp_tile_bf16.cuh",
                 "__host__ __device__ inline size_t base_bytes(int k0)") == (
        "return1024+(size_t)E_BYTES+(k0>128?(size_t)ROWS*gn16::round64(k0)"
        "*2:0)+gn16::W_BYTES+CS_BYTES;")
    assert _body("mlp_tile_bf16.cuh",
                 "__host__ __device__ inline int xs_tiles(int k0, int n)") == (
        "intt=n-1;while(t>0&&base_bytes(k0)+(size_t)t*XS_BYTES>SMEM_LIMIT)"
        "--t;returnt;")
    assert _body("mlp_tile_bf16.cuh",
                 "__host__ __device__ inline size_t smem_bytes(int k0, int n)"
                 ) == "returnbase_bytes(k0)+(size_t)xs_tiles(k0,n)*XS_BYTES;"
    # the plan's column-sum rows are the bf16 tile's
    plan = re.sub(r"\s+", "", (CSRC / "mlp_chain_bwd.cu").read_text())
    assert ("std::is_same<Act,tc::bf16>::value?mlp16::ROWS:ROWS;" in plan)
    assert "grid=(unsigned)((a.rows+ROWS-1)/ROWS);" in re.sub(
        r"\s+", "", (CSRC / "mlp_chain_bwd_bf16.cu").read_text())


#: (widths, LayerNorm, preact_input, need_dx) of every chain backward the
#: three families' bf16 training steps launch (tests/test_torch_cuda.py's
#: BF16_CHAIN_SHAPES)
MODEL_CHAINS = [([128, 128, 128, 3], False, False, True),
                ([258, 128, 128, 128], True, False, True),
                ([128, 128, 128], True, True, True),
                ([130, 128, 128, 128], True, False, True),
                ([2, 128, 128, 128], False, False, False),
                ([5, 128, 128, 128], False, False, False),
                ([128, 128, 1], False, False, True),
                ([4, 128, 128], True, False, False),
                ([3, 128, 128], True, False, False)]


def test_every_launched_chain_fits_one_block():
    """Every chain the bf16 paths launch gets a tile within one block's
    232,448 bytes, with the f32 tiles of all its hidden layers where its
    input is at most 128 wide (the flagship encoders, tails and decoders:
    at most two hidden layers); inputs up to 576 wide and chains of up to
    8 layers fit too, with fewer tiles.  A block of 512 threads may use
    128 registers a thread."""
    assert fused_mlp.BF16_BWD_THREADS * 128 <= 65536
    for dims, *_ in MODEL_CHAINS:
        n = len(dims) - 1
        smem = fused_mlp.bf16_bwd_smem(dims[0], n)
        assert smem <= _build.MAX_SMEM
        if dims[0] <= 128:
            assert fused_mlp.bf16_bwd_xs_tiles(dims[0], n) == n - 1
            assert smem == 1024 + 32768 + 32768 + 5120 + (n - 1) * 67584
    assert fused_mlp.bf16_bwd_xs_tiles(258, 3) == 1
    for k0 in (2, 128, 576):
        for n in range(1, 9):
            assert fused_mlp.bf16_bwd_smem(k0, n) <= _build.MAX_SMEM
    assert fused_mlp._bf16_bwd_base(577) > _build.MAX_SMEM


def test_every_launched_product_fits_the_kernel():
    """The weight-gradient products of those chains and of the three
    families' GN blocks: N at most 128 (one n128 product), D bf16, and the
    launch within the plan's MAX_PRODS products."""
    products = []
    for dims, _, preact, _ in MODEL_CHAINS:
        products.append(wgrad.chain_products(40448, dims, preact))
    for V, k, fv, ne in ((40448, 6, 128, 3), (102400, 5, 128, 2),
                         (40448, 6, 256, 3), (8192, 6, 256, 3)):
        products.append(wgrad.gn_products(
            V, k, 128, fv, [128 + 2 * fv] + [128] * ne,
            [128 + fv] + [128] * ne))
    for launch in products:
        assert 1 <= len(launch) <= wgrad.MAX_PRODS
        for rows, K, N, _ in launch:
            assert 1 <= N <= 128 and K >= 1
        _, blocks, _ = wgrad.plan([p[:3] for p in launch])
        assert 0 < blocks < 2 ** 31


def test_weight_grads_on_the_cpu_is_the_plain_version():
    """On CPU tensors ``weight_grads`` is the plain version and launches
    nothing: bf16-rounded operands under the bf16 policy (an f32 X rounded
    too), the f32 product under f32."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(300, 5)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32))
    before = launch_counts()
    got16, got32 = wgrad.weight_grads([(x, d.to(torch.bfloat16)), (x, d)])
    assert launch_counts() == before
    xr = x.to(torch.bfloat16).double()
    dr = d.to(torch.bfloat16).double()
    assert got16.dtype == got32.dtype == torch.float32
    torch.testing.assert_close(got16.double(), xr.t() @ dr, rtol=1e-6,
                               atol=1e-5)
    torch.testing.assert_close(got32.double(), x.double().t() @ d.double(),
                               rtol=1e-5, atol=1e-5)
