"""The copy and Init engines' host side, on CPU tensors:
`copy_engine.routes` picks `copy_2d`'s kernel (the bulk copy for one
dense, 16-byte-aligned run from `BULK_MIN_BYTES`; the gather for any
other view; the transforms' own kernels) from shape, strides, element
size and the base address, which the tests pass as integers where
alignment is the point; `init_engine.pattern_word` is the 32-bit pattern
memset's kernel writes.  The kernels themselves are held bit for bit
against the plain versions on the card (`test_torch_kernels_cuda.py`).
"""

import functools
import importlib
import re
from pathlib import Path

import pytest
import torch

from repro_torch.core import instream
from repro_torch.kernels.init_engine import memset_ref

CE = importlib.import_module("repro_torch.kernels.copy_engine.copy_engine")
IE = importlib.import_module("repro_torch.kernels.init_engine.init_engine")
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
MIB = 1 << 20
BIG = CE.BULK_MIN_BYTES + 4 * MIB      # above the copy's threshold
DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int8,
          torch.uint8, torch.bool, torch.int16, torch.int32]


def _dense(nbytes: int, dtype=torch.bfloat16, cols: int = 1024):
    """A dense (rows, cols) tensor of at least `nbytes` bytes."""
    e = torch.empty((), dtype=dtype).element_size()
    return torch.zeros((-(-nbytes // (cols * e)), cols), dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_copy_route_dense_aligned_takes_bulk(dtype):
    x = _dense(BIG, dtype)
    assert CE.routes(x, "copy", address=4096) == ("bulk", "gather")
    assert CE.route(x, address=4096) == "bulk"


@pytest.mark.parametrize("offset", [1, 2, 4, 8, 12, 15])
def test_copy_route_unaligned_base_takes_gather(offset):
    x = _dense(BIG, torch.int8)
    assert CE.routes(x, "copy", address=4096 + offset) == ("gather",)


def test_copy_route_views_one_element_past_an_aligned_base():
    """A view at element offset 1 is 2 or 4 bytes off its aligned
    storage: the bulk route refuses it, whatever the storage's base."""
    base = _dense(BIG + 64, torch.bfloat16)
    flat = base.reshape(-1)
    n = BIG // 2
    view = flat[1:1 + n].view(-1, 1024)
    assert CE.route(view, address=4096 + 2) == "gather"
    assert CE.route(flat[8:8 + n].view(-1, 1024), address=4096 + 16) \
        == "bulk"
    # with the real addresses the two views are 2 and 16 bytes apart
    assert (view.data_ptr() - base.data_ptr()) % 16 == 2


@pytest.mark.parametrize("view", ["columns", "transposed", "every other row",
                                  "expanded", "step 2"])
def test_copy_route_strided_views_take_gather(view):
    x = _dense(2 * BIG, torch.float32)
    v = {"columns": x[:, :1000],
         "transposed": x.t(),
         "every other row": x[::2],
         "expanded": x[:1].expand(x.shape[0], 1024),
         "step 2": x[:, ::2]}[view]
    assert CE.routes(v, "copy", address=4096) == ("gather",)


def test_copy_route_contiguous_row_slice_takes_bulk():
    """Rows of a dense matrix are one dense run too."""
    x = _dense(2 * BIG, torch.float32)
    assert CE.route(x[10:-10], address=4096) == "bulk"


@pytest.mark.parametrize("nbytes,want", [
    (CE.BULK_MIN_BYTES - 2048, ("gather", "bulk")),
    (CE.BULK_MIN_BYTES, ("bulk", "gather")),
    (16, ("gather", "bulk")),
    (0, ("gather",))])
def test_copy_route_threshold_and_empty(nbytes, want):
    x = torch.zeros((1, nbytes // 2), dtype=torch.bfloat16)
    assert CE.routes(x, "copy", address=4096) == want


@pytest.mark.parametrize("op", ["zero", "convert"])
def test_copy_route_transforms_keep_their_kernels(op):
    assert CE.routes(_dense(BIG), op, address=4096) == (op,)


def test_copy_route_follows_check_copy_2d():
    """A cast to the input's own dtype is a copy, so it may go bulk."""
    x = _dense(BIG, torch.float32)
    to_f32 = functools.partial(instream.cast, dtype=torch.float32)
    op, _, _ = CE.check_copy_2d(x, to_f32, torch.float32)
    assert CE.route(x, op, address=0) == "bulk"
    op, _, _ = CE.check_copy_2d(x.bfloat16(), to_f32, torch.float32)
    assert CE.route(x.bfloat16(), op, address=0) == "convert"


EVERY_DTYPE = DTYPES + [torch.uint16, torch.uint32]


@pytest.mark.parametrize("dtype", EVERY_DTYPE)
@pytest.mark.parametrize("value", [2.5, 300, -1, -0.0])
def test_memset_pattern_word_is_the_plain_versions_bytes(dtype, value):
    """Every 4 bytes the kernel writes, little-endian, are the plain
    version's: bf16 −0.0 is 00 80 00 80, 300 into int8 2c 2c 2c 2c."""
    want = memset_ref((1, 16), value, dtype, "cpu").view(torch.uint8)
    word = IE.pattern_word(value, dtype)
    assert list(word.to_bytes(4, "little")) == want.reshape(-1)[:4].tolist()


def test_bulk_chunk_size_matches_the_source():
    """The card tests size their cases around the chunk the CUDA source
    builds with."""
    text = (CSRC / "copy_engine.cu").read_text()
    found = re.search(r"constexpr int CHUNK = (\d+);", text)
    assert found and int(found.group(1)) == CE.BULK_CHUNK_BYTES


def test_wrappers_refuse_cpu_tensors():
    x = torch.zeros((8, 128))
    with pytest.raises(ValueError, match="CUDA device"):
        CE.copy_2d_cuda(x, kernel_route="bulk")
    with pytest.raises(ValueError, match="CUDA device"):
        IE.memset_cuda((8, 128), 0.0, device="cpu")
