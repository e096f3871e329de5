"""The port's one Philox draw (``csrc/common.cuh`` ``philox_word0``) and its
plain version (``ops.fused_block_train.philox_word0``): against an
independent Philox4x32-10 on Python integers, the mask of a range against
the slices of a longer one, the tensor-parallel span / gap remap against the
whole mask's heads, the drop pass's plain version, that every CUDA source
draws through the one header, and ``tools/philox_bound``'s reading of SASS.
CPU only: the kernels are held to these plain versions on the card
(``chip_smoke.py``)."""

from __future__ import annotations

import glob
import os
import re

import numpy as np
import pytest
import torch

from afft_tpu_torch.ops import fused_block_train as FT
from afft_tpu_torch.ops import fused_gpt2_train as FGT
from afft_tpu_torch.tools import philox_bound as PB

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "afft_tpu_torch", "csrc")
SEEDS = (20240607, 1234567)
M32 = 0xFFFFFFFF


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11) on Python integers: the four
    output words of a 128-bit counter under a 64-bit key."""
    c, k = list(counter), list(key)
    for _ in range(10):
        p0 = 0xD2511F53 * c[0]
        p1 = 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k[0]) & M32, p1 & M32,
             ((p0 >> 32) ^ c[3] ^ k[1]) & M32, p0 & M32]
        k = [(k[0] + 0x9E3779B9) & M32, (k[1] + 0xBB67AE85) & M32]
    return c


# indices on both sides of 2^32 and at the counter's 64-bit ends
INDICES = [0, 1, 3, 255, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1, 2 ** 32,
           2 ** 32 + 1, 5 * 2 ** 32 + 12345, 2 ** 62 + 7, 2 ** 63 - 1]


@pytest.mark.parametrize("seeds", [(0, 0), (2 ** 31 - 1, 2 ** 31 - 1),
                                   (0, 2 ** 31 - 1), SEEDS])
@pytest.mark.parametrize("block, site", [(0, 0), (M32, M32), (5, 3),
                                         (0, M32), (M32, 0)])
def test_philox_word0_matches_python_integers(seeds, block, site):
    got = FT.philox_word0(torch.tensor(INDICES, dtype=torch.int64), *seeds,
                          block, site).tolist()
    want = [philox4x32_10((i & M32, i >> 32, block, site), seeds)[0]
            for i in INDICES]
    assert got == want


def test_philox_known_answer():
    """The Random123 known-answer vectors of Philox4x32-10 (counter and key
    all zeros, all ones): the reference above is Philox itself."""
    assert philox4x32_10((0, 0, 0, 0), (0, 0)) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert philox4x32_10((M32,) * 4, (M32, M32)) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


@pytest.mark.parametrize("offset, n", [(0, 1), (7, 100), (2 ** 32 - 50, 100),
                                       (3 * 2 ** 32 + 11, 37)])
def test_mask_of_a_range_is_the_slice_of_a_longer_one(offset, n):
    """The mask of [offset, offset + n) equals the slice of the mask of
    [0, offset + n): a multiplier depends on its logical index alone. Long
    ranges are compared through the window just before offset."""
    thr, inv = FT.rates_operands(0.5, 0.5, 0.5)
    start = max(0, offset - 4096)
    whole = FT.site_mask_plain(offset + n - start, SEEDS, 2, 1, thr[1],
                               inv[1], offset=start)
    part = FT.site_mask_plain(n, SEEDS, 2, 1, thr[1], inv[1], offset=offset)
    assert torch.equal(part, whole[offset - start:])
    assert 0 < int((part == 0).sum()) < n or n < 8


def test_row0_masks_are_the_global_batch_rows():
    """draw_masks at row0 equal rows row0 .. of the mask from row 0, past
    2^32 for the proj and MLP sites (row0 * N * C > 2^32)."""
    R, N, C, H = 3, 5, 8, 2
    row0 = 2 ** 31 - 1
    part = FT.draw_masks_plain(R, N, C, H, SEEDS, 4, 0.5, 0.5, 0.5, row0=row0)
    for site, m in enumerate(part):
        per_row = m.numel() // R
        thr, inv = FT.rates_operands(0.5, 0.5, 0.5)
        want = FT.site_mask_plain(R * per_row, SEEDS, 4, site,
                                  thr[FT._RATE_OF_SITE[site]],
                                  inv[FT._RATE_OF_SITE[site]],
                                  offset=row0 * per_row)
        assert torch.equal(m.reshape(-1), want)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("row0", [0, 2 ** 31 - 1])
def test_tensor_parallel_remap_is_the_whole_masks_heads(tp, row0):
    """Rank r's attention mask through the span / gap remap (rank r holds
    heads r * H / tp ..) equals the whole layer's mask at those heads: the
    plain path and the CPU route of draw_site_mask."""
    B, T, C, H = 3, 6, 16, 4
    whole = FGT.draw_masks_gpt2_plain(B, T, C, H, SEEDS, 3, 0.5, 0.1,
                                      row0=row0)[0]
    thr, inv = FT.rates_operands(0.5, 0.5, 0.5)
    local, nn = H // tp, T * T
    for rank in range(tp):
        kw = dict(offset=row0 * H * nn + rank * local * nn, span=local * nn,
                  gap=(H - local) * nn)
        plain = FT.site_mask_plain(B * local * nn, SEEDS, 3, 0, thr[0],
                                   inv[0], **kw)
        routed = FT.draw_site_mask(B * local * nn, SEEDS, 3, 0, 0.5,
                                   device="cpu", **kw)
        want = whole[:, rank * local:(rank + 1) * local].reshape(-1)
        assert torch.equal(plain, want) and torch.equal(routed, want)


@pytest.mark.parametrize("branch, sites", [("attn", (1, 2)),
                                           ("mlp", (3, 4))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_drop_grad_plain_is_d_times_both_multipliers(branch, sites, dtype):
    """The drop pass's plain version: (d x its row's drop-path multiplier)
    x its element's dropout multiplier, rounded to d's dtype, from the
    block's masks at row0."""
    R, N, C, row0 = 6, 5, 12, 7
    d = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (R, N, C)).astype(np.float32)).to(dtype)
    masks = FT.draw_masks_plain(R, N, C, 2, SEEDS, 1, 0.1, 0.3, 0.5,
                                row0=row0)
    elem, rows = masks[sites[0]], masks[sites[1]]
    want = ((d.float() * rows.reshape(R, 1, 1)) * elem.reshape(R, N, C))
    got = FT.drop_grad(d, SEEDS, 1, 0.3, 0.5, branch=branch, row0=row0)
    assert got.dtype == dtype and torch.equal(got, want.to(dtype))


def test_check_wrappers_refuse_bad_arguments():
    with pytest.raises(ValueError, match="site"):
        FT.draw_site_mask(4, SEEDS, 0, 7, 0.1, device="cpu")
    with pytest.raises(ValueError, match="seeds"):
        FT.drop_grad_plain(torch.zeros(1, 1, 1), (-1, 0), 0, 0.1, 0.1,
                           branch="mlp")
    with pytest.raises(ValueError, match="branch"):
        FT.drop_grad(torch.zeros(1, 1, 1), SEEDS, 0, 0.1, 0.1, branch="fc")


def test_one_header_holds_the_draw():
    """The Philox multipliers appear in exactly one CUDA header, so every
    caller (the GEMM's dropout epilogue, the attentions, drop_grad and the
    mask kernel) draws through the one philox_word0."""
    holders = []
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(path) as f:
            text = f.read()
        if re.search(r"0x(D2511F53|CD9E8D57)", text, re.IGNORECASE):
            holders.append(os.path.basename(path))
    assert holders == ["common.cuh"]
    with open(os.path.join(CSRC, "common.cuh")) as f:
        text = f.read()
    assert text.count("__device__ __forceinline__ unsigned philox_word0") == 1
    for path in glob.glob(os.path.join(CSRC, "*.cu*")):
        with open(path) as f:
            assert "__umulhi(0x" not in f.read(), path


# Two kernels in cuobjdump's form. The first: a tile loop whose vector
# path draws (two Philox multiplies) and writes 4 elements with one 16-byte
# store, whose other path runs an inner loop of one element a turn, and its
# latch. The second, the earlier one-element form: one element a turn, a
# remap region that a predicated branch skips.
SASS = """
        Function : _ZN4afft17fill_masks_kernelENS_9MaskTableE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   IMAD.WIDE.U32 R2, R0, -0x2daee0ad, RZ ;
        /*0030*/              @P0 BRA 0x80 ;
        /*0040*/                   IMAD.WIDE.U32 R4, R2, -0x326172a9, RZ ;
        /*0050*/                   LOP3.LUT R6, R4, R5, R2, 0x96, !PT ;
        /*0060*/                   STG.E.128 desc[UR4][R8.64], R4 ;
        /*0070*/                   BRA 0xb0 ;
        /*0080*/                   IMAD R4, R2, -0x2daee0ad, RZ ;
        /*0090*/                   STG.E desc[UR4][R8.64], R4 ;
        /*00a0*/              @P1 BRA 0x80 ;
        /*00b0*/                   IADD3 R0, R0, 0x1, RZ ;
        /*00c0*/              @P2 BRA 0x20 ;
        /*00d0*/                   EXIT ;
        Function : _ZN4afft9fill_maskEPfmNS_8DropSiteE
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   IMAD.WIDE.U32 R2, R0, -0x2daee0ad, RZ ;
        /*0020*/              @!P0 BRA 0x50 ;
        /*0030*/                   IMAD R3, R2, 0x9, RZ ;
        /*0040*/                   IADD3 R2, R2, R3, RZ ;
        /*0050*/                   LOP3.LUT R4, R2, R0, RZ, 0x96, !PT ;
        /*0060*/                   STG.E desc[UR4][R8.64], R4 ;
        /*0070*/              @P1 BRA 0x10 ;
        /*0080*/                   EXIT ;
"""


def test_philox_bound_counts_the_tile_loops_drawing_path():
    got = PB.count_kernel(SASS, ("17fill_masks_kernelE",), 4)
    assert got["elements_a_turn"] == 4
    assert got["philox_multiplies"] == 2
    assert got["turn_instructions"] == {
        "fma_heavy": 2, "imad_wide": 2, "fp32": 0, "alu": 2, "lsu": 1,
        "control": 3, "all": 8}
    assert got["per_element"]["all"] == 2.0
    assert PB.sm_clocks(got["per_element"]) == 2 / 128


def test_philox_bound_clocks_by_pipe():
    """An element's clocks: the busiest of dispatch (128 a clock an SM),
    the FMA-heavy pipe and the ALU (64 each; an IMAD.WIDE taking the
    probe's slots) and the FMA pipes together (128)."""
    per = {"all": 10, "fma_heavy": 8, "imad_wide": 8, "fp32": 4, "alu": 2}
    assert PB.sm_clocks(per) == 8 / 64
    assert PB.sm_clocks(per, wide_slots=2.0) == 16 / 64
    per = {"all": 40, "fma_heavy": 2, "imad_wide": 0, "fp32": 30, "alu": 3}
    assert PB.sm_clocks(per) == 40 / 128
    per = {"all": 20, "fma_heavy": 2, "imad_wide": 0, "fp32": 2, "alu": 16}
    assert PB.sm_clocks(per) == 16 / 64


def test_philox_bound_skips_what_the_draw_does_not_run():
    got = PB.count_kernel(SASS, ("9fill_maskE",), 4)
    assert got["elements_a_turn"] == 1
    # the loop 0x10 .. 0x70 less the region 0x30 .. 0x40 that @!P0 skips
    assert got["turn_instructions"]["all"] == 5
    assert got["turn_instructions"]["fma_heavy"] == 1
    assert PB.store_bytes((0, "STG", "", False, ".E.U16")) == 2
    assert PB.store_bytes((0, "STG", "", False, ".E.128")) == 16
    assert PB.count_kernel(SASS, ("no_such_kernel",), 4) is None
